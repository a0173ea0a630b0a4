// K18: the MSM's lane tree, the sum of a batch's lane partials by pairwise
// halving, one launch a tree (all witnesses of a batch in it), written
// once over the field type and instantiated for G1 (Fq) and G2 (Fq2).
//
// Replaces, on the windowed MSM's last step, the reference's tree_reduce
// (zkp2p_tpu/ops/msm.py), which runs one Pallas g1_add / g2_add
// (zkp2p_tpu/ops/pallas_curve.py) a level; the port's step loop
// (ops/msm.py: tree_reduce_steps) launched K2 a level, 12 to 14 launches
// a tree.  The pairing is the loop's exactly: a level of n points, padded
// with one infinity at its end when n is odd, becomes the h = ceil(n/2)
// sums p[i] + p[i + h] (p[i] itself where i + h = n, since an add of
// infinity returns p), and the add is point.cuh's complete add, so the
// Jacobian limbs equal the loop's bit for bit.
//
// n_k = ceil(n_0 / 2^k) points remain after k levels, and element i of
// level k is the sum of the level-0 elements i + sum_j b_j n_j over the
// levels j > k it passed.  A block that owns the outputs [a, a + P) of
// level K loads the 2^K x P level-0 points it needs (slot s of P points:
// offset sum_{j=1..K} bit(s, K - j) n_j; those past n_0 at infinity) into
// shared memory and halves them K times in place, the levels separated by
// __syncthreads(): at level k, slot s adds slot s + 2^(K-k-1), whose
// level-k index is n_{k+1} higher, when that index is below n_k, and
// keeps its point otherwise.  A slot whose own index is past n_k is
// never added, and never read by a slot that is.
//
// A tree of at most LT_CAP lanes is one block a witness (P = 1).  A
// larger one (the narrow classes' 16,384 lanes, the h MSM's 4,096) runs
// its first K levels in several blocks a witness (2^K P = LT_CAP, K the
// fewest levels that leave at most LT_CAP points), each writing its P
// outputs to a scratch buffer the wrapper allocates; the last block of a
// witness to finish (a counter a witness, after a __threadfence) reads
// them back and runs the remaining levels.  One launch either way.
//
// What bounds it: the latency of the levels, one dependent add each; the
// lanes' adds (lanes - 1 a witness) are few against the card's multiply
// rate.  So each add runs as K10/K11 run theirs (point_coop.cuh:
// coop_add), its independent products over three threads in 6 rounds,
// over mont_cc.cuh's PTX product: LT_GROUPS groups of 96 threads a block,
// 32 adds a group, so that a level's 128 adds (LT_CAP / 2) are one round
// of the block.  In a chain of adds on an NVIDIA H100 80GB HBM3 (700 W;
// tools/kernel_variants.py), one thread an add took 26.3 us (G1) and
// 86.0 us (G2) an add, three threads an add 11.8 us and 35.9 us.
#include "mont_cc.cuh"
#include "point_coop.cuh"

constexpr int LT_GROUPS = 4;
constexpr int LT_THREADS = 96 * LT_GROUPS;
constexpr int LT_CAP = 64 * LT_GROUPS;  // points in a block's shared memory: two a thread of a role

// The partner point of an add, slot e of the block's points [3][cap],
// read at each use.
template <class E>
struct LtRef {
  const E* pts;
  int cap;
  int e;
  __device__ __forceinline__ E at(int coord) const { return pts[coord * cap + e]; }
};

// A point of a global (batch, n, 16-bit limbs) array through L2 (not the
// SM's L1): the scratch buffer other blocks of this launch wrote.
__device__ __forceinline__ Fe lt_load_cg(const Fe*, const int32_t* p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  Fe r;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int4 v = __ldcg(q + k);
    r.w[2 * k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.w[2 * k + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}
__device__ __forceinline__ Fe2 lt_load_cg(const Fe2*, const int32_t* p) {
  const Fe* tag = nullptr;
  return Fe2{lt_load_cg(tag, p), lt_load_cg(tag, p + 16)};
}

// n_k = ceil(n0 / 2^k)
__device__ __forceinline__ int lt_count(int n0, int k) { return (int)(((long long)n0 + (1LL << k) - 1) >> k); }

// One block's part of a tree: the outputs [a, a + per_block) of level
// `levels` of the witness whose n0 level-0 points start at in (x, y, z),
// into out (the witness's level-`levels` array).  Every thread of the
// block calls it; it synchronises.  `cg`: read the input through L2.
template <class E>
__device__ void lt_levels(E* pts, E (*S)[32], const int32_t* const* in, bool cg, int n0, int levels, int per_block,
                          int a, int32_t* const* out, const FieldConst& c) {
  const int cap = per_block << levels;
  const E* tag = nullptr;
  const E zero = f_zero(E{});
  for (int e = threadIdx.x; e < cap; e += blockDim.x) {
    const int s = e / per_block;
    long long idx = a + (e - s * per_block);
    for (int j = 1; j <= levels; ++j)
      if ((s >> (levels - j)) & 1) idx += lt_count(n0, j);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      E v = zero;
      if (idx < n0) v = cg ? lt_load_cg(tag, in[r] + idx * (int)(sizeof(E) / 2)) : f_load(tag, in[r], idx);
      pts[r * cap + e] = v;
    }
  }
  __syncthreads();
  const int ln = threadIdx.x & 31;
  const int role = (threadIdx.x >> 5) % 3;
  const int g = threadIdx.x / 96;
  for (int k = 0; k < levels; ++k) {
    const int half = cap >> (k + 1);
    const int n_k = lt_count(n0, k), h = lt_count(n0, k + 1);
    for (int e0 = 0; e0 < half; e0 += 32 * LT_GROUPS) {
      const int e = e0 + 32 * g + ln;
      // a lane past the level, or past the pad, stores nothing; its p is
      // infinity, so that it never takes the add's doubling (a barrier
      // of the whole block)
      bool live = false;
      if (e < half) {
        const int s = e / per_block;
        long long idx = a + (e - s * per_block);
        for (int j = k + 2; j <= levels; ++j)
          if ((s >> (levels - j)) & 1) idx += lt_count(n0, j);
        live = idx + h < n_k;
      }
      S[SX + role][ln] = live ? pts[role * cap + e] : zero;
      __syncthreads();
      coop_add<MulCC>(S, ln, role, LtRef<E>{pts, cap, live ? e + half : 0}, c);
      if (live) pts[role * cap + e] = S[SX + role][ln];
      __syncthreads();
    }
  }
  const int n_out = lt_count(n0, levels);
  for (int e = threadIdx.x; e < per_block && a + e < n_out; e += blockDim.x) {
#pragma unroll
    for (int r = 0; r < 3; ++r) f_store(out[r], a + e, pts[r * cap + e]);
  }
}

// blockIdx.y is the witness.  levels_b < 0: one stage, the whole tree of
// n0 points (levels_a levels, per_block 1) into out.  Otherwise stage A's
// blocks write their outputs to the scratch buffer (n_a = ceil(n0 /
// 2^levels_a) points a witness), and the witness's last block runs
// stage B over them (levels_b levels) into out.  Shared memory: the
// block's points [3][LT_CAP], then each group's coop_add values
// [N_SLOTS][32].
template <class E>
__global__ void __launch_bounds__(LT_THREADS)
k_lane_tree(const int32_t* __restrict__ x, const int32_t* __restrict__ y, const int32_t* __restrict__ z,
            int32_t* sx, int32_t* sy, int32_t* sz, int* counters, int32_t* __restrict__ ox,
            int32_t* __restrict__ oy, int32_t* __restrict__ oz, int n0, int levels_a, int per_block, int levels_b,
            FieldConst c) {
  extern __shared__ int4 lt_smem[];
  __shared__ bool last;
  E* pts = reinterpret_cast<E*>(lt_smem);
  E(*S)[32] = reinterpret_cast<E(*)[32]>(pts + 3 * LT_CAP) + N_SLOTS * (threadIdx.x / 96);
  constexpr long long W2 = sizeof(E) / 2;  // int32 limbs a point coordinate
  const long long b = blockIdx.y;
  const long long in_off = b * n0 * W2;
  const int32_t* in[3] = {x + in_off, y + in_off, z + in_off};
  int32_t* out[3] = {ox + b * W2, oy + b * W2, oz + b * W2};
  if (levels_b < 0) {
    lt_levels<E>(pts, S, in, false, n0, levels_a, 1, 0, out, c);
    return;
  }
  const int n_a = lt_count(n0, levels_a);
  const long long s_off = b * n_a * W2;
  int32_t* scratch[3] = {sx + s_off, sy + s_off, sz + s_off};
  lt_levels<E>(pts, S, in, false, n0, levels_a, per_block, blockIdx.x * per_block, scratch, c);
  __threadfence();  // this block's outputs are visible before its count is
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + b, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int32_t* again[3] = {scratch[0], scratch[1], scratch[2]};
  lt_levels<E>(pts, S, again, true, n_a, levels_b, 1, 0, out, c);
}

// The wrapper (ops/cuda_lane_tree.py: tree_plan) plans the stages; this
// checks that they fit the block.
template <class E>
static int launch_lane_tree(const void* x, const void* y, const void* z, void* sx, void* sy, void* sz, void* counters,
                            void* ox, void* oy, void* oz, int batch, int n0, int levels_a, int per_block,
                            int blocks, int levels_b, const void* consts, void* stream) {
  if (batch <= 0) return 0;
  if ((per_block << levels_a) > LT_CAP || (levels_b >= 0 && (1 << levels_b) > LT_CAP)) return (int)cudaErrorInvalidValue;
  const int smem = (3 * LT_CAP + LT_GROUPS * N_SLOTS * 32) * (int)sizeof(E);  // 110 KB (G1), 221 KB (G2)
  cudaError_t err = cudaFuncSetAttribute(k_lane_tree<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_lane_tree<E><<<dim3((unsigned)blocks, (unsigned)batch), LT_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)sx, (int32_t*)sy, (int32_t*)sz,
      (int*)counters, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n0, levels_a, per_block, levels_b, c);
  return (int)cudaGetLastError();
}

extern "C" {

int zk_g1_lane_tree(const void* x, const void* y, const void* z, void* sx, void* sy, void* sz, void* counters,
                    void* ox, void* oy, void* oz, int batch, int n0, int levels_a, int per_block, int blocks,
                    int levels_b, const void* consts, void* stream) {
  return launch_lane_tree<Fe>(x, y, z, sx, sy, sz, counters, ox, oy, oz, batch, n0, levels_a, per_block, blocks,
                              levels_b, consts, stream);
}

int zk_g2_lane_tree(const void* x, const void* y, const void* z, void* sx, void* sy, void* sz, void* counters,
                    void* ox, void* oy, void* oz, int batch, int n0, int levels_a, int per_block, int blocks,
                    int levels_b, const void* consts, void* stream) {
  return launch_lane_tree<Fe2>(x, y, z, sx, sy, sz, counters, ox, oy, oz, batch, n0, levels_a, per_block, blocks,
                               levels_b, consts, stream);
}

}  // extern "C"
