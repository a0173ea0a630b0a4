// K10, K11: the Horner fold of a windowed MSM's digit-plane partials, the
// whole fold in one launch, for G1 and for G2:
//   K10 zk_g1_horner_fold   over Fq
//   K11 zk_g2_horner_fold   over Fq2
// For every lane: acc = init, then for each plane p, most significant
// first, `window` times acc = double(acc), then acc = add(acc, plane[p]);
// acc is written once.
//
// Replaces the Pallas kernels g1_double / g2_double (and the fold's
// g1_add / g2_add) of the reference (zkp2p_tpu/ops/pallas_curve.py), which
// its horner_fold_planes (zkp2p_tpu/ops/msm.py) launches once per step of
// a lax.scan: n_planes x (window doublings + 1 add), each over all lanes,
// reading and writing the lanes' three coordinates through device memory.
// The doubling and the add compute point.cuh's pt_double and pt_add
// (dbl-2009-l, add-2007-bl): the same field operations on the same
// operands and the same case selects in the same order; the order of the
// steps is the scan's.  So the output limbs equal the step loop's
// (ops/msm.py, _fold_steps) bit for bit.
//
// What bounds it on an H100: the chain's latency.  A lane's fold is a
// serial chain of n_planes x window doublings and n_planes adds, and a
// fold has 1 to 16,384 lanes, so the card holds them all in one wave with
// a warp or so per SM sub-partition: nothing hides a thread's latency, and
// its time is the number of dependent Montgomery products times a
// product's latency.  Counted from point.cuh, the critical path of a
// doubling is 3 products (A -> E^2 -> E (D - X3), B -> C and (X+B)^2 beside
// it) and that of an add 5 (Z1^2 -> U2 -> H -> H^2 -> H^3 -> S1 H^3; the
// three Fq products of an Fq2 product are independent, so it is one deep),
// where one thread a lane runs all 7 and 16 products one after another.
// So the design spreads a lane's independent products over threads:
//   - three threads a lane, one in each warp of a 96-thread block (32
//     lanes); in each round every warp runs one of the round's independent
//     products, then the block synchronises: 3 rounds a doubling and 6 an
//     add (point_coop.cuh: coop_double, coop_add, shared with K18), the
//     lane's values in shared memory;
//   - each plane partial is read once from device memory: the plane's
//     coordinate each warp selects is prefetched into L1 before the
//     plane's doublings, so its latency hides behind them, and read from
//     L1 at the add; neighbouring lanes sit at neighbouring addresses.
// Measured on an NVIDIA H100 80GB HBM3 (700 W), one call, bitwise equal
// (G1 h fold 4,096 lanes x 64 planes; G2 b2 wide fold 572 x 64; window 4):
//   this kernel                                     G1 2.68 ms, G2 7.93 ms
//   one thread a lane, blocks of 32 / 64 / 128      G1 3.70 / 3.66 / 3.76 ms,
//     (G2 addend read from L1 at each use)          G2 16.63 / 16.36 / 16.60 ms
//   one thread a lane, G2 addend held in registers  G2 16.76 / 16.43 / 16.39 ms
//     (another call; both G2 forms 255 registers with 0.5 KB of spill)
//   the step loop (_fold_steps, K4 and K2 a step)   G1 15.76 ms, G2 16.01 ms
// ptxas: 80 registers for K10, 138 for K11, no spill.  One thread a lane
// is no faster than the step loop on the G2 wide fold: the step loop's
// launches are as long as their device work there.
#include "point_coop.cuh"

__device__ __forceinline__ void prefetch_l1(const int32_t* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// The plane partial q of one lane, read from L1 at each use.
template <class E>
struct PlaneRef {
  const int32_t* x;
  const int32_t* y;
  const int32_t* z;
  __device__ __forceinline__ E at(int coord) const {
    return f_load_each((const E*)nullptr, coord == 0 ? x : (coord == 1 ? y : z));
  }
};

// init (lanes, *elem) x3, planes (n_planes, lanes, *elem) x3 -> out
// (lanes, *elem) x3.  blockDim = 96: lane = blockIdx.x * 32 + threadIdx.x
// % 32, role = threadIdx.x / 32.  Lanes past the end compute on the last
// lane's data and store nothing, so that every thread meets every barrier.
template <class E>
__global__ void __launch_bounds__(96)
k_horner_fold(const int32_t* __restrict__ ix, const int32_t* __restrict__ iy, const int32_t* __restrict__ iz,
              const int32_t* __restrict__ px, const int32_t* __restrict__ py, const int32_t* __restrict__ pz,
              int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, int lanes,
              int n_planes, int window, FieldConst c) {
  __shared__ E S[N_SLOTS][32];
  constexpr int W = sizeof(E) / 2;  // int32 limbs an element: two 16-bit limbs a word of E
  const int ln = threadIdx.x & 31;
  const int role = threadIdx.x >> 5;
  const int l = blockIdx.x * 32 + ln;
  const int lr = min(l, lanes - 1);
  const E* tag = nullptr;
  S[SX + role][ln] = f_load(tag, role == 0 ? ix : (role == 1 ? iy : iz), lr);
  __syncthreads();
  const int32_t* mine = role == 0 ? px : (role == 1 ? py : pz);
  // one loop over the fold's n_planes x (window + 1) steps: step k of a
  // plane is a doubling for k < window and the plane's add for k = window
  // (nvcc 12.9's cicc crashed on a doubling loop nested in a plane loop)
  const long long steps = (long long)n_planes * (window + 1);
  long long at = lr * (long long)W;  // plane p's element of lane lr
  int k = 0;
#pragma unroll 1
  for (long long s = 0; s < steps; ++s) {
    if (k == 0) prefetch_l1(mine + at);  // the coordinate this role selects
    if (k < window) {
      coop_double(S, ln, role, SX, SY, SZ, c);
      ++k;
      continue;
    }
    coop_add(S, ln, role, PlaneRef<E>{px + at, py + at, pz + at}, c);
    at += (long long)lanes * W;
    k = 0;
  }
  if (l < lanes) f_store(role == 0 ? ox : (role == 1 ? oy : oz), l, S[SX + role][ln]);
}

template <class E>
static int launch_fold(const void* ix, const void* iy, const void* iz, const void* px, const void* py,
                       const void* pz, void* ox, void* oy, void* oz, long long lanes, int n_planes, int window,
                       const void* consts, void* stream) {
  if (lanes <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_horner_fold<E><<<(unsigned)((lanes + 31) / 32), 96, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ix, (const int32_t*)iy, (const int32_t*)iz, (const int32_t*)px, (const int32_t*)py,
      (const int32_t*)pz, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int)lanes, n_planes, window, c);
  return (int)cudaGetLastError();
}

extern "C" {

// init x/y/z (lanes, 16), planes x/y/z (n_planes, lanes, 16), out x/y/z
// (lanes, 16); lanes < 2^31.
int zk_g1_horner_fold(const void* ix, const void* iy, const void* iz, const void* px, const void* py,
                      const void* pz, void* ox, void* oy, void* oz, long long lanes, int n_planes, int window,
                      const void* consts, void* stream) {
  return launch_fold<Fe>(ix, iy, iz, px, py, pz, ox, oy, oz, lanes, n_planes, window, consts, stream);
}

// zk_g1_horner_fold over Fq2: elements (2, 16)
int zk_g2_horner_fold(const void* ix, const void* iy, const void* iz, const void* px, const void* py,
                      const void* pz, void* ox, void* oy, void* oz, long long lanes, int n_planes, int window,
                      const void* consts, void* stream) {
  return launch_fold<Fe2>(ix, iy, iz, px, py, pz, ox, oy, oz, lanes, n_planes, window, consts, stream);
}

}  // extern "C"
