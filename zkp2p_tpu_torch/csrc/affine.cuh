// The batch-affine arm's device code, shared by batch_inv.cu (K15) and
// affine_add.cu (K16): one field inversion, a block-local batch inversion
// and the complete affine add, written over the field type (Fe = Fq or Fr,
// Fe2 = Fq2) as point.cuh writes the Jacobian formulas.
//
// One inversion (fe_inv).  The reference inverts a batch inversion's total
// by Fermat, a^(N-2) in one Pallas kernel (zkp2p_tpu/ops/pallas_mont.py:
// mont_pow; K5 here): 253 squarings and 110 multiplies, one dependent chain
// of 363 Montgomery products.  fe_inv runs a binary extended Euclid on the
// integer aR instead: with u = aR, v = N, x1 = 1, x2 = 0 and the invariant
// aR * x1 = u, aR * x2 = v (mod N), it subtracts the smaller of the odd u, v
// from the larger (and x2 from x1, or x1 from x2, mod N), then strips the
// difference's trailing zeros, at most 31 a round, dividing its x by the
// same power of 2 mod N (x + mN with m = x * (-N^-1) mod 2^k, shifted right
// by k).  It ends at u = v = 1 with x1 = (aR)^-1; one Montgomery product by
// R^3 mod N turns that into a^-1 R, K5's output (the inverse of a nonzero
// element is unique, so the limbs are K5's whatever the algorithm).  Its
// time depends on its input: the number of rounds is the number of
// subtractions, about 0.7 per bit of u and v (zkp2p_tpu_torch/ops/
// cuda_affine.py: inv_model is the same loop over Python ints).  A round
// is one 256-bit compare-subtract, one subtract mod N and a strip or two
// (a multiply-add chain and funnel shifts), some 40 32-bit instructions in
// PTX carry chains, where a Montgomery product is 136 dependent
// multiply-adds.
//
// Block-local batch inversion (block_inverse_many, block_inverse).  Each
// thread of a block brings K values and multiplies them into one leaf;
// the block builds a product tree over the leaves in shared memory
// (blockDim.x - 1 products, log2(blockDim.x) levels), one thread inverts
// the root, and the inverses come back down the tree (two products a
// node): inv(left) = inv(parent) * right, inv(right) = inv(parent) * left;
// each thread then walks its K values back.  About 3 products an element
// and one inversion a block, with no trip to the host and nothing across
// blocks.  A zero value takes one into the products and gets 0 back.  Fq2
// values take the norm route: the block inverts the norms a^2 + b^2 in Fq
// and each thread multiplies its conjugate by its norm's inverse, as
// ops/msm_affine.py's plain route does.
//
// The affine add (aff_den, aff_apply): the reference's complete add in two
// phases (zkp2p_tpu/ops/msm_affine.py: _affine_add_den, _affine_add_apply;
// the port's twins in zkp2p_tpu_torch/ops/msm_affine.py), with its four
// exceptional cases in the same order and the same (0, 0) sentinel: phase
// 1 gives the denominator (x2 - x1, or 2 y1 for a doubling; one where the
// result needs none), phase 2 the sum from its inverse.  Every value is
// canonical, so the limbs are the plain route's.
#pragma once

#include "point.cuh"

struct InvConst {
  uint32_t r3[8];  // R^3 mod N, R = 2^256
};

// The inversion's 256-bit adds and subtracts as PTX carry chains: one
// instruction a word (add.cc/addc, sub.cc/subc, mad.lo.cc/madc.hi.cc),
// where mont.cuh's C carries through 64-bit temporaries take about four.
// Only fe_inv uses them; every other kernel's arithmetic is mont.cuh's.
// The outputs are early-clobber: a word is written before the later
// words of the inputs are read.

// d = a - b mod 2^256; returns 1 where a < b
__device__ __forceinline__ uint32_t inv_sub(Fe& d, const Fe& a, const Fe& b) {
  uint32_t br;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(d.w[0]), "=&r"(d.w[1]), "=&r"(d.w[2]), "=&r"(d.w[3]), "=&r"(d.w[4]), "=&r"(d.w[5]),
        "=&r"(d.w[6]), "=&r"(d.w[7]), "=&r"(br)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]),
        "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
  return br & 1u;
}

// a + (b AND mask) mod 2^256
__device__ __forceinline__ Fe inv_add_masked(const Fe& a, const uint32_t* b, uint32_t mask) {
  Fe d;
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=&r"(d.w[0]), "=&r"(d.w[1]), "=&r"(d.w[2]), "=&r"(d.w[3]), "=&r"(d.w[4]), "=&r"(d.w[5]),
        "=&r"(d.w[6]), "=&r"(d.w[7])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]),
        "r"(b[0] & mask), "r"(b[1] & mask), "r"(b[2] & mask), "r"(b[3] & mask), "r"(b[4] & mask),
        "r"(b[5] & mask), "r"(b[6] & mask), "r"(b[7] & mask));
  return d;
}

// (a - b) mod N for canonical a, b: the same value as mont.cuh's fe_sub
__device__ __forceinline__ Fe inv_sub_mod(const Fe& a, const Fe& b, const FieldConst& c) {
  Fe d;
  const uint32_t br = inv_sub(d, a, b);
  return inv_add_masked(d, c.n, 0u - br);
}

// a >> k for 1 <= k <= 31
__device__ __forceinline__ Fe fe_shr(const Fe& a, int k) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 7; ++j) r.w[j] = __funnelshift_r(a.w[j], a.w[j + 1], k);
  r.w[7] = a.w[7] >> k;
  return r;
}

// x / 2^k mod N for x < N, 1 <= k <= 31: (x + mN) / 2^k with
// m = x * (-N^-1) mod 2^k, which is below (N + (2^k - 1) N) / 2^k = N.
// x + mN < 2^287: the low halves of m * N[j] in one carry chain, the high
// halves one word up in a second.
__device__ __forceinline__ Fe fe_div_pow2(const Fe& x, int k, const FieldConst& c) {
  const uint32_t m = (x.w[0] * c.n0) & ((1u << k) - 1u);
  uint32_t t[9];
  asm("mad.lo.cc.u32 %0, %9, %10, %18;\n\t"
      "madc.lo.cc.u32 %1, %9, %11, %19;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %20;\n\t"
      "madc.lo.cc.u32 %3, %9, %13, %21;\n\t"
      "madc.lo.cc.u32 %4, %9, %14, %22;\n\t"
      "madc.lo.cc.u32 %5, %9, %15, %23;\n\t"
      "madc.lo.cc.u32 %6, %9, %16, %24;\n\t"
      "madc.lo.cc.u32 %7, %9, %17, %25;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %10, %1;\n\t"
      "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
      "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
      "madc.hi.u32 %8, %9, %17, %8;"
      : "=&r"(t[0]), "=&r"(t[1]), "=&r"(t[2]), "=&r"(t[3]), "=&r"(t[4]), "=&r"(t[5]), "=&r"(t[6]), "=&r"(t[7]),
        "=&r"(t[8])
      : "r"(m), "r"(c.n[0]), "r"(c.n[1]), "r"(c.n[2]), "r"(c.n[3]), "r"(c.n[4]), "r"(c.n[5]), "r"(c.n[6]),
        "r"(c.n[7]), "r"(x.w[0]), "r"(x.w[1]), "r"(x.w[2]), "r"(x.w[3]), "r"(x.w[4]), "r"(x.w[5]), "r"(x.w[6]),
        "r"(x.w[7]));
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = __funnelshift_r(t[j], t[j + 1], k);
  return r;
}

// the trailing zeros stripped in one round: at most 31
__device__ __forceinline__ int strip_bits(const Fe& u) { return u.w[0] ? __ffs(u.w[0]) - 1 : 31; }

// u odd, with x divided by the same power of 2
__device__ __forceinline__ void make_odd(Fe& u, Fe& x, const FieldConst& c) {
  while (!(u.w[0] & 1u)) {
    const int k = strip_bits(u);
    u = fe_shr(u, k);
    x = fe_div_pow2(x, k, c);
  }
}

// a^-1 R for a = aR in Montgomery form (nonzero, canonical); 0 -> 0.
__device__ __noinline__ Fe fe_inv(const Fe& a, const FieldConst& c, const InvConst& ic) {
  if (fe_is_zero(a)) return fe_zero();
  Fe u = a, v, x1 = fe_zero(), x2 = fe_zero();
#pragma unroll
  for (int j = 0; j < 8; ++j) v.w[j] = c.n[j];
  x1.w[0] = 1;
  make_odd(u, x1, c);
  while (true) {
    Fe d;
    const uint32_t borrow = inv_sub(d, u, v);  // u - v
    if (fe_is_zero(d)) break;                   // u = v = gcd = 1
    if (!borrow) {
      u = d;
      x1 = inv_sub_mod(x1, x2, c);
      make_odd(u, x1, c);
    } else {
      inv_sub(v, v, u);
      x2 = inv_sub_mod(x2, x1, c);
      make_odd(v, x2, c);
    }
  }
  Fe r3;
#pragma unroll
  for (int j = 0; j < 8; ++j) r3.w[j] = ic.r3[j];
  return fe_mul(x1, r3, c);  // (aR)^-1 * R^3 * R^-1 = a^-1 R
}

// Shared memory the block's tree takes: 2 * blockDim.x - 1 elements.
__host__ __device__ constexpr size_t tree_bytes(int threads) { return (size_t)(2 * threads - 1) * sizeof(Fe); }

// The inverse of one nonzero leaf a thread by the block's product tree;
// blockDim.x a power of 2.  Every thread of the block calls it: it
// synchronises, and leaves `tree` free for the next call.
__device__ Fe tree_inverse(const Fe& leaf, Fe* tree, const FieldConst& c, const InvConst& ic) {
  const int B = blockDim.x;
  const int t = threadIdx.x;
  tree[t] = leaf;
  __syncthreads();
  int off = 0;  // the level of n nodes at off, its parents at off + n
  for (int n = B; n > 1; n >>= 1) {
    if (t < n / 2) tree[off + n + t] = fe_mul(tree[off + 2 * t], tree[off + 2 * t + 1], c);
    off += n;
    __syncthreads();
  }
  if (t == 0) tree[off] = fe_inv(tree[off], c, ic);  // off = 2B - 2, the root
  __syncthreads();
  for (int n = 2; n <= B; n <<= 1) {  // parents (n/2 nodes) at off, children at off - n
    const int child = off - n;
    if (t < n / 2) {
      const Fe p = tree[off + t];
      const Fe l = tree[child + 2 * t];
      const Fe r = tree[child + 2 * t + 1];
      tree[child + 2 * t] = fe_mul(p, r, c);
      tree[child + 2 * t + 1] = fe_mul(p, l, c);
    }
    off = child;
    __syncthreads();
  }
  const Fe r = tree[t];
  __syncthreads();
  return r;
}

// The block-local batch inversion of K values a thread, in place (0 ->
// 0): the thread's running products of its values (Montgomery's trick)
// give one leaf, the block's tree inverts the leaves, and the thread walks
// its products back (3 products a value).  K = 4 shares one inversion
// among 4 x blockDim.x values, where the inversion's one busy thread
// would otherwise hold up the block's 256 threads for every 256 values.
template <int K>
__device__ void block_inverse_many(Fe (&v)[K], Fe* tree, const FieldConst& c, const InvConst& ic) {
  uint32_t zero = 0;
  Fe pre[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (fe_is_zero(v[k])) {
      zero |= 1u << k;
      v[k] = fe_one(c);
    }
    pre[k] = k ? fe_mul(pre[k - 1], v[k], c) : v[k];
  }
  Fe inv = tree_inverse(pre[K - 1], tree, c, ic);
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const Fe vk = v[k];
    v[k] = k ? fe_mul(inv, pre[k - 1], c) : inv;
    if (k) inv = fe_mul(inv, vk, c);
    if ((zero >> k) & 1u) v[k] = fe_zero();
  }
}

// What the Fq tree inverts for an element, and the element's inverse
// from that: Fq itself; Fq2 by the norm route, (a - bu) * (a^2 + b^2)^-1.
__device__ __forceinline__ Fe inv_key(const Fe& a, const FieldConst&) { return a; }
__device__ __forceinline__ Fe inv_key(const Fe2& a, const FieldConst& c) {
  return fe_add(fe_mul(a.c0, a.c0, c), fe_mul(a.c1, a.c1, c), c);
}
__device__ __forceinline__ Fe inv_apply(const Fe&, const Fe& ki, const FieldConst&) { return ki; }
__device__ __forceinline__ Fe2 inv_apply(const Fe2& a, const Fe& ki, const FieldConst& c) {
  return Fe2{fe_mul(a.c0, ki, c), fe_sub(fe_zero(), fe_mul(a.c1, ki, c), c)};
}

// One value a thread (K16's accumulate, whose thread owns one lane).
template <class E>
__device__ E block_inverse(const E& v, Fe* tree, const FieldConst& c, const InvConst& ic) {
  Fe k[1] = {inv_key(v, c)};
  block_inverse_many<1>(k, tree, c, ic);
  return inv_apply(v, k[0], c);
}

// ------------------------------------------------------ the affine add

__device__ __forceinline__ bool f_eq(const Fe& a, const Fe& b) {
  uint32_t o = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) o |= a.w[k] ^ b.w[k];
  return o == 0;
}
__device__ __forceinline__ bool f_eq(const Fe2& a, const Fe2& b) { return f_eq(a.c0, b.c0) && f_eq(a.c1, b.c1); }

template <class E>
struct Aff {
  E x, y;
  bool inf;
};

// The case flags of one add: dbl (same point, both live), res_inf (P + (-P),
// or the doubling of a point with y = 0).
struct AddCase {
  bool dbl, res_inf;
};

// Phase 1: the denominator this lane gives the batch inversion; one for
// the exceptional lanes, so that the batch product stays invertible.
template <class E>
__device__ __forceinline__ E aff_den(const Aff<E>& a, const Aff<E>& b, AddCase& k, const FieldConst& c) {
  const bool live = !a.inf && !b.inf;
  const bool x_eq = f_eq(a.x, b.x);
  const bool y_eq = f_eq(a.y, b.y);
  k.dbl = x_eq && y_eq && live;
  k.res_inf = (x_eq && !y_eq && live) || (k.dbl && f_is_zero(a.y));
  if (k.res_inf || !live) return f_one(a.x, c);
  return k.dbl ? f_add(a.y, a.y, c) : f_sub(b.x, a.x, c);
}

// Phase 2, with the inverted denominator: lambda = num / den, x3 = lambda^2
// - x1 - x2, y3 = lambda (x1 - x3) - y1; then the reference's selects in its
// order (addend at infinity keeps the accumulator, accumulator at infinity
// takes the addend, so that a double infinity stays (0, 0)).
template <class E>
__device__ __forceinline__ Aff<E> aff_apply(const Aff<E>& a, const Aff<E>& b, const E& dinv, const AddCase& k,
                                            const FieldConst& c) {
  if (a.inf) return b;
  if (b.inf) return a;
  if (k.res_inf) return Aff<E>{f_zero(a.x), f_zero(a.x), true};
  E num;
  if (k.dbl) {
    const E sq = f_mul(a.x, a.x, c);
    num = f_add(f_add(sq, sq, c), sq, c);
  } else {
    num = f_sub(b.y, a.y, c);
  }
  const E lam = f_mul(num, dinv, c);
  Aff<E> r;
  r.x = f_sub(f_sub(f_mul(lam, lam, c), a.x, c), b.x, c);
  r.y = f_sub(f_mul(lam, f_sub(a.x, r.x, c), c), a.y, c);
  r.inf = false;
  return r;
}
