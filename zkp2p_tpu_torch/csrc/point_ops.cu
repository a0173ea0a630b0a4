// K2-K4: BN254 Jacobian point operations, one thread per lane, written
// once over the field type and instantiated for G1 (Fq) and G2 (Fq2):
//   K2 add        complete Jacobian + Jacobian (add-2007-bl)
//   K3 add_mixed  Jacobian + affine, (0, 0) lifted to Z = 0
//   K4 double     dbl-2009-l; infinity maps to infinity
//
// Replaces the Pallas kernels g1_add, g1_add_mixed, g1_double, g2_add,
// g2_add_mixed, g2_double of the reference (zkp2p_tpu/ops/pallas_curve.py:
// _add_math, _add_mixed_math, _add_core_math, _double_math over _FqOps /
// _Fq2Ops), which keep a whole point operation in VMEM.  Here a thread
// reads its operands once, keeps every intermediate in registers and
// writes the result once.  The point math (point.cuh, shared with
// msm_window.cu) is the reference's formulas and case selects, so the
// output limbs equal it bit for bit.
//
// What bounds it on an H100: integer multiply throughput (a G1 add is 16
// Montgomery products; an Fq2 product is 3), not bytes.  The G2
// instantiation holds six Fq2 coordinates plus temporaries per thread and
// spills registers (the build log, ptxas -v, shows how much).  Cooperative
// multi-thread field products and wgmma/TMA-style layouts are later work.
#include "point.cuh"

template <class E>
__global__ void __launch_bounds__(128)
k_add(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1, const int32_t* __restrict__ z1,
      const int32_t* __restrict__ x2, const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
      int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const E* tag = nullptr;
  Jac<E> p{f_load(tag, x1, i), f_load(tag, y1, i), f_load(tag, z1, i)};
  Jac<E> q{f_load(tag, x2, i), f_load(tag, y2, i), f_load(tag, z2, i)};
  Jac<E> r = pt_add(p, q, c);
  f_store(ox, i, r.x);
  f_store(oy, i, r.y);
  f_store(oz, i, r.z);
}

template <class E>
__global__ void __launch_bounds__(128)
k_add_mixed(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1, const int32_t* __restrict__ z1,
            const int32_t* __restrict__ x2, const int32_t* __restrict__ y2,
            int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n,
            FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const E* tag = nullptr;
  Jac<E> p{f_load(tag, x1, i), f_load(tag, y1, i), f_load(tag, z1, i)};
  Jac<E> r = pt_add_mixed(p, f_load(tag, x2, i), f_load(tag, y2, i), c);
  f_store(ox, i, r.x);
  f_store(oy, i, r.y);
  f_store(oz, i, r.z);
}

template <class E>
__global__ void __launch_bounds__(128)
k_double(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1, const int32_t* __restrict__ z1,
         int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, long long n, FieldConst c) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const E* tag = nullptr;
  Jac<E> p{f_load(tag, x1, i), f_load(tag, y1, i), f_load(tag, z1, i)};
  Jac<E> r = pt_double(p, c);
  f_store(ox, i, r.x);
  f_store(oy, i, r.y);
  f_store(oz, i, r.z);
}

static inline unsigned grid_for(long long n) { return (unsigned)((n + 127) / 128); }

#define I const int32_t*
#define O int32_t*

template <class E>
static int launch_add(const void* const* in, void* const* out, long long n, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_add<E><<<grid_for(n), 128, 0, (cudaStream_t)stream>>>((I)in[0], (I)in[1], (I)in[2], (I)in[3], (I)in[4],
                                                         (I)in[5], (O)out[0], (O)out[1], (O)out[2], n, c);
  return (int)cudaGetLastError();
}

template <class E>
static int launch_add_mixed(const void* const* in, void* const* out, long long n, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_add_mixed<E><<<grid_for(n), 128, 0, (cudaStream_t)stream>>>((I)in[0], (I)in[1], (I)in[2], (I)in[3],
                                                               (I)in[4], (O)out[0], (O)out[1], (O)out[2], n, c);
  return (int)cudaGetLastError();
}

template <class E>
static int launch_double(const void* const* in, void* const* out, long long n, const void* consts, void* stream) {
  if (n <= 0) return 0;
  FieldConst c = *reinterpret_cast<const FieldConst*>(consts);
  k_double<E><<<grid_for(n), 128, 0, (cudaStream_t)stream>>>((I)in[0], (I)in[1], (I)in[2], (O)out[0],
                                                            (O)out[1], (O)out[2], n, c);
  return (int)cudaGetLastError();
}

#undef I
#undef O

extern "C" {

int zk_g1_add(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2, const void* z2,
              void* ox, void* oy, void* oz, long long n, const void* consts, void* stream) {
  const void* in[6] = {x1, y1, z1, x2, y2, z2};
  void* out[3] = {ox, oy, oz};
  return launch_add<Fe>(in, out, n, consts, stream);
}

int zk_g1_add_mixed(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2,
                    void* ox, void* oy, void* oz, long long n, const void* consts, void* stream) {
  const void* in[5] = {x1, y1, z1, x2, y2};
  void* out[3] = {ox, oy, oz};
  return launch_add_mixed<Fe>(in, out, n, consts, stream);
}

int zk_g1_double(const void* x1, const void* y1, const void* z1, void* ox, void* oy, void* oz, long long n,
                 const void* consts, void* stream) {
  const void* in[3] = {x1, y1, z1};
  void* out[3] = {ox, oy, oz};
  return launch_double<Fe>(in, out, n, consts, stream);
}

int zk_g2_add(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2, const void* z2,
              void* ox, void* oy, void* oz, long long n, const void* consts, void* stream) {
  const void* in[6] = {x1, y1, z1, x2, y2, z2};
  void* out[3] = {ox, oy, oz};
  return launch_add<Fe2>(in, out, n, consts, stream);
}

int zk_g2_add_mixed(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2,
                    void* ox, void* oy, void* oz, long long n, const void* consts, void* stream) {
  const void* in[5] = {x1, y1, z1, x2, y2};
  void* out[3] = {ox, oy, oz};
  return launch_add_mixed<Fe2>(in, out, n, consts, stream);
}

int zk_g2_double(const void* x1, const void* y1, const void* z1, void* ox, void* oy, void* oz, long long n,
                 const void* consts, void* stream) {
  const void* in[3] = {x1, y1, z1};
  void* out[3] = {ox, oy, oz};
  return launch_double<Fe2>(in, out, n, consts, stream);
}

}  // extern "C"
