// The cooperative point operations of K10/K11 (msm_fold.cu) and K18
// (lane_tree.cu): point.cuh's pt_double and pt_add for 32 lanes at a
// time, each lane's independent Montgomery products spread over three
// threads, one in each warp of a group of 96 (role = warp), its values in
// shared memory, the group's threads meeting at a barrier after each
// round of products.  The same field operations on the same operands and
// the same case selects in the same order as point.cuh's, so the same
// limbs; 3 rounds a doubling and 6 an add where one thread runs 7 and 16
// products one after another.  The barriers are the block's: every thread
// of a block calls each operation the same number of times.  M is the
// Montgomery product (point.cuh: MulC, the default, or mont_cc.cuh's
// MulCC); the add's addend q is read through q.at(coord) at each use.
#pragma once

#include "point.cuh"

// A lane's values in shared memory, 32 lanes a group: the accumulator
// (SX, SY, SZ), the add's generic result (GX, GY, GZ) and the temporaries
// of one point operation from T0 on.
enum : int { SX, SY, SZ, GX, GY, GZ, T0 };
// the doubling's temporaries, and where the add's doubling branch puts
// its result (DX, DY, DZ: temporaries the doubling does not use)
enum : int { dA = T0, dB, dYZ, dXB2, dC, dFv, DX, DY, DZ };
// the add's temporaries
enum : int { aZ1Z1 = T0, aZ2Z2, aYZ1, aU2, aU1, aYZ2, aS1, aS2, aZ1Z2, aHH, aR2, aHHH, aV, aRV, aSH, N_SLOTS };

// pt_double of the accumulator over the three warps of a group, role r =
// warp r: each round's products are independent and run one a warp, then
// the block synchronises.  3 rounds, one product deep each, where one
// thread would run the 7 products one after another.  Writes
// (ox, oy, oz); the same operations as point.cuh's pt_double.
template <class M = MulC, class E>
__device__ __forceinline__ void coop_double(E (*S)[32], int ln, int role, int ox, int oy, int oz,
                                            const FieldConst& c) {
  if (role == 0) {
    const E x = S[SX][ln];
    S[dA][ln] = f_mul<M>(x, x, c);
  } else if (role == 1) {
    const E y = S[SY][ln];
    S[dB][ln] = f_mul<M>(y, y, c);
  } else {
    S[dYZ][ln] = f_mul<M>(S[SY][ln], S[SZ][ln], c);
  }
  __syncthreads();
  if (role == 0) {
    const E XB = f_add(S[SX][ln], S[dB][ln], c);
    S[dXB2][ln] = f_mul<M>(XB, XB, c);
  } else if (role == 1) {
    const E B = S[dB][ln];
    S[dC][ln] = f_mul<M>(B, B, c);
  } else {
    const E A = S[dA][ln];
    const E Ev = f_add(f_add(A, A, c), A, c);
    S[dFv][ln] = f_mul<M>(Ev, Ev, c);
  }
  __syncthreads();
  // no role reads SX, SY, SZ in this round, so (ox, oy, oz) may be them
  if (role == 0) {
    const E A = S[dA][ln];
    const E C = S[dC][ln];
    const E t = f_sub(f_sub(S[dXB2][ln], A, c), C, c);
    const E D = f_add(t, t, c);
    const E Ev = f_add(f_add(A, A, c), A, c);
    const E X3 = f_sub(S[dFv][ln], f_add(D, D, c), c);
    E C8 = f_add(C, C, c);
    C8 = f_add(C8, C8, c);
    C8 = f_add(C8, C8, c);
    S[ox][ln] = X3;
    S[oy][ln] = f_sub(f_mul<M>(Ev, f_sub(D, X3, c), c), C8, c);
  } else if (role == 1) {
    const E YZ = S[dYZ][ln];
    S[oz][ln] = f_add(YZ, YZ, c);
  }
  __syncthreads();
}

// pt_add(acc, q) over the three warps: 6 rounds of independent products
// (Z1^2, Z2^2, Y1 Z2 | U2, U1, Y2 Z1 | S1, S2, Z1 Z2 | H^2, R^2, Z3 |
// H^3, V | R (V - X3), S1 H^3), where one thread would run the 16
// products one after another; then point.cuh's case selects, in its
// order.  The doubling branch runs coop_double when any lane of the block
// takes it, so that every thread meets the same barriers.
template <class M = MulC, class E, class Q>
__device__ __forceinline__ void coop_add(E (*S)[32], int ln, int role, const Q& q, const FieldConst& c) {
  if (role == 0) {
    const E z1 = S[SZ][ln];
    S[aZ1Z1][ln] = f_mul<M>(z1, z1, c);
  } else if (role == 1) {
    const E z2 = q.at(2);
    S[aZ2Z2][ln] = f_mul<M>(z2, z2, c);
  } else {
    S[aYZ1][ln] = f_mul<M>(S[SY][ln], q.at(2), c);
  }
  __syncthreads();
  if (role == 0) {
    S[aU2][ln] = f_mul<M>(q.at(0), S[aZ1Z1][ln], c);
  } else if (role == 1) {
    S[aU1][ln] = f_mul<M>(S[SX][ln], S[aZ2Z2][ln], c);
  } else {
    S[aYZ2][ln] = f_mul<M>(q.at(1), S[SZ][ln], c);
  }
  __syncthreads();
  if (role == 0) {
    S[aS1][ln] = f_mul<M>(S[aYZ1][ln], S[aZ2Z2][ln], c);
  } else if (role == 1) {
    S[aS2][ln] = f_mul<M>(S[aYZ2][ln], S[aZ1Z1][ln], c);
  } else {
    S[aZ1Z2][ln] = f_mul<M>(S[SZ][ln], q.at(2), c);
  }
  __syncthreads();
  const E H = f_sub(S[aU2][ln], S[aU1][ln], c);
  const E Rr = f_sub(S[aS2][ln], S[aS1][ln], c);
  if (role == 0) {
    S[aHH][ln] = f_mul<M>(H, H, c);
  } else if (role == 1) {
    S[aR2][ln] = f_mul<M>(Rr, Rr, c);
  } else {
    S[GZ][ln] = f_mul<M>(S[aZ1Z2][ln], H, c);
  }
  __syncthreads();
  if (role == 0) {
    S[aHHH][ln] = f_mul<M>(H, S[aHH][ln], c);
  } else if (role == 1) {
    S[aV][ln] = f_mul<M>(S[aU1][ln], S[aHH][ln], c);
  }
  __syncthreads();
  if (role == 0) {
    const E V = S[aV][ln];
    const E X3 = f_sub(f_sub(S[aR2][ln], S[aHHH][ln], c), f_add(V, V, c), c);
    S[GX][ln] = X3;
    S[aRV][ln] = f_mul<M>(Rr, f_sub(V, X3, c), c);
  } else if (role == 1) {
    S[aSH][ln] = f_mul<M>(S[aS1][ln], S[aHHH][ln], c);
  }
  __syncthreads();
  const bool q_inf = f_is_zero(q.at(2));
  const bool p_inf = f_is_zero(S[SZ][ln]);
  const bool same_x = f_is_zero(H);
  const bool same_y = f_is_zero(Rr);
  if (role == 0) S[GY][ln] = f_sub(S[aRV][ln], S[aSH][ln], c);
  if (__syncthreads_or(!q_inf && !p_inf && same_x && same_y)) coop_double<M>(S, ln, role, DX, DY, DZ, c);
  // role r selects coordinate r, reading no other role's coordinate
  E v;
  if (q_inf) {
    v = S[SX + role][ln];
  } else if (p_inf) {
    v = q.at(role);
  } else if (same_x && same_y) {
    v = S[DX + role][ln];
  } else if (same_x) {
    v = f_zero(E{});
  } else {
    v = S[GX + role][ln];
  }
  S[SX + role][ln] = v;
  __syncthreads();
}

