// Shallow-water DFR spatial operator on the cubed sphere, one launch per call,
// and the two small kernels of its halo glue.
//
// sw_operator_kernel replaces the TPU kernels wxfactory_tpu/ops/pallas_sw_gen.py::
// km_gen (body _panel_body, with pallas_sw._element_stage and _ausm_slots) and,
// for s=4, pallas_sw.py::km_fused: absolute form or, with the base planes
// (PERT), the perturbation form (_element_stage_pert, _ausm_delta_slots, the
// float64 base RHS added last); optional RK stage combination a*x + b*q +
// cdt*RHS(q); optional emission of the output's panel-edge traces for the next
// stage's halo. Its body is swk::element_block (csrc/sw_element.cuh). The plain
// torch version of the same function is wxfactory_tpu_torch/ops/sw_operator.py::
// sw_operator_plain (sw_operator_pert_plain); the wrapper sw_operator there
// launches this kernel.
//
// sw_edges_kernel replaces pallas_sw.py::ke_edges: the panel-edge traces
// (3, 4, 6, nel, s) of a state, the chain's bootstrap (plain version:
// ops/sw_operator.py::edge_traces). sw_halo_kernel replaces pallas_sw.py::
// kh_exchange: neighbour permutation, edge flips and the 2x2 contravariant
// rotation of the momenta, traces in, halo out (plain version: halo_from_traces).
// Both serve every (nel, s), and the halo is linear, so the same kernel takes
// absolute and delta traces.
//
// Layouts: csrc/sw_element.cuh.
//
// Design: one thread per solution point, EB = 256 / s^2 elements per block;
// EE/DD/CC and each element's state, pointwise fluxes and face fluxes in
// shared memory. In the perturbation form the base planes are read from global
// memory per thread (the node's h0, hu0, u0, rhs0 and the faces' base traces
// and halo), so the shared memory of a block does not grow.
//
// What bounds it (H100 SXM, s=3, float64, per element and call): about
// 0.7-0.9 KB of device-memory traffic (state 216 B in and 216 B out, x 216 B
// in stage mode, gridrot 72 B; the single-panel metric, 13 fields, and the
// neighbours' states mostly hit L2) against about 3.8 kFLOP (dense 18x9
// divergence and 12x9 correction products, 24 face extrapolations, pointwise
// fluxes, 12 AUSM fluxes): ~4-5 FLOP/B, under the card's f64 balance of
// ~10 FLOP/B (34 TFLOP/s vector f64 over 3.35 TB/s), so the kernel is
// memory-bound in principle; at nel=64 both bounds are under 10 us, so in
// practice block-level latency (two or three barriers per block, low
// occupancy at large s) dominates. The perturbation form reads 14 base planes
// more (about 2.3x the state's bytes) and does about twice the face work. The
// dense EE/DD/CC products do s times the FLOPs of their Kronecker factors;
// using the 1D factors is later work. The halo and edge kernels move a few
// hundred KB and are bound by their launch.

#include <cuda_runtime.h>

#include "sw_element.cuh"

namespace {

using swk::OpArgs;
using swk::Shape;

template <typename T, int S, bool PERT>
__global__ void __launch_bounds__(swk::kThreads) sw_operator_kernel(OpArgs<T> A) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  swk::load_ops<T, S>(A.ops, smem);
  swk::element_block<T, S, PERT, false>(A, blockIdx.x, smem);
}

template <typename T, int S>
__global__ void __launch_bounds__(swk::kThreads) sw_edges_kernel(const T* __restrict__ q, const T* __restrict__ ops,
                                                                 T* __restrict__ traces, int nel) {
  const long long total = 3LL * 24 * nel * S;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total; t += (long long)gridDim.x * blockDim.x)
    traces[t] = swk::trace_point<T, S>(q, ops, nel, t);
}

template <typename T>
__global__ void __launch_bounds__(swk::kThreads) sw_halo_kernel(const T* __restrict__ traces, const int* __restrict__ src,
                                                                const int* __restrict__ flip,
                                                                const T* __restrict__ conv, T* __restrict__ halo,
                                                                int npts) {
  const int total = 24 * npts;
  const long long vstride = 24LL * npts;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < total; t += gridDim.x * blockDim.x) {
    const int row = t / npts;
    T out[3];
    swk::halo_point(traces, src, flip, conv, npts, row, t - row * npts, out);
#pragma unroll
    for (int v = 0; v < 3; ++v) halo[v * vstride + t] = out[v];
  }
}

template <typename T, int S, bool PERT>
cudaError_t launch_operator(const OpArgs<T>& A, cudaStream_t stream) {
  using Sh = Shape<S>;
  const size_t smem = Sh::smem_bytes(sizeof(T));
  static bool configured = false;
  if (!configured && smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sw_operator_kernel<T, S, PERT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int nelem = 6 * A.nel * A.nel;
  const int blocks = (nelem + Sh::EB - 1) / Sh::EB;
  sw_operator_kernel<T, S, PERT><<<blocks, Sh::THREADS, smem, stream>>>(A);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_operator(int s, const OpArgs<T>& A, bool pert, cudaStream_t stream) {
#define SW_CASE(S) \
  case S:          \
    return pert ? launch_operator<T, S, true>(A, stream) : launch_operator<T, S, false>(A, stream);
  switch (s) {
    SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5) SW_CASE(6) SW_CASE(7) SW_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef SW_CASE
}

template <typename T>
cudaError_t dispatch_edges(int s, int nel, const void* q, const void* ops, void* traces, cudaStream_t stream) {
  const int total = 3 * 24 * nel * s;
  const int blocks = (total + swk::kThreads - 1) / swk::kThreads;
  const T* qq = static_cast<const T*>(q);
  const T* oo = static_cast<const T*>(ops);
  T* tt = static_cast<T*>(traces);
#define SW_CASE(S)                                                                  \
  case S:                                                                           \
    sw_edges_kernel<T, S><<<blocks, swk::kThreads, 0, stream>>>(qq, oo, tt, nel); \
    break;
  switch (s) {
    SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5) SW_CASE(6) SW_CASE(7) SW_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef SW_CASE
  return cudaGetLastError();
}

template <typename T>
OpArgs<T> op_args(int nel, const void* q, const void* halo, const void* ops, const void* fields,
                  const void* gridrot, const void* itf_x, const void* itf_y, const void* x,
                  const void* q0, const void* u0, const void* itf0, const void* halo0, const void* rhs0,
                  void* out, void* traces, double a, double b, double cdt, int stage) {
  OpArgs<T> A{};
  A.q = static_cast<const T*>(q);
  A.halo = static_cast<const T*>(halo);
  A.ops = static_cast<const T*>(ops);
  A.fields = static_cast<const T*>(fields);
  A.gridrot = static_cast<const T*>(gridrot);
  A.itf_x = static_cast<const T*>(itf_x);
  A.itf_y = static_cast<const T*>(itf_y);
  A.x = static_cast<const T*>(x);
  A.out = static_cast<T*>(out);
  A.traces = static_cast<T*>(traces);
  A.q0 = static_cast<const T*>(q0);
  A.u0 = static_cast<const T*>(u0);
  A.itf0 = static_cast<const T*>(itf0);
  A.halo0 = static_cast<const T*>(halo0);
  A.rhs0 = static_cast<const T*>(rhs0);
  A.nel = nel;
  A.a = T(a);
  A.b = T(b);
  A.cdt = T(cdt);
  A.stage = stage;
  return A;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). x == NULL: no x term;
// traces == NULL: no trace emission; stage == 0: out = RHS(q); q0 != NULL:
// the perturbation form (q, halo, x, out and traces carry deltas; u0, itf0,
// halo0 and rhs0 are then read too).
extern "C" int sw_operator_launch(int is_f64, int s, int nel, const void* q, const void* halo,
                                  const void* ops, const void* fields, const void* gridrot,
                                  const void* itf_x, const void* itf_y, const void* x, const void* q0,
                                  const void* u0, const void* itf0, const void* halo0, const void* rhs0,
                                  void* out, void* traces, double a, double b, double cdt, int stage,
                                  void* stream) {
  if (nel < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pert = q0 != nullptr;
  if (pert && (u0 == nullptr || itf0 == nullptr || halo0 == nullptr || rhs0 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      is_f64 ? dispatch_operator<double>(s, op_args<double>(nel, q, halo, ops, fields, gridrot, itf_x, itf_y, x, q0,
                                                            u0, itf0, halo0, rhs0, out, traces, a, b, cdt, stage),
                                         pert, st)
             : dispatch_operator<float>(s, op_args<float>(nel, q, halo, ops, fields, gridrot, itf_x, itf_y, x, q0,
                                                          u0, itf0, halo0, rhs0, out, traces, a, b, cdt, stage),
                                        pert, st);
  return (int)err;
}

// Panel-edge traces (3, 4, 6, nel, s) of q; ops as for sw_operator_launch
// (only its EE block is read).
extern "C" int sw_edges_launch(int is_f64, int s, int nel, const void* q, const void* ops, void* traces,
                               void* stream) {
  if (nel < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? dispatch_edges<double>(s, nel, q, ops, traces, st)
                      : dispatch_edges<float>(s, nel, q, ops, traces, st));
}

// Halo (3, 4, 6, npts) from traces (3, 4, 6, npts), npts = nel * s; src and
// flip (24) int32, conv (4, 24, npts).
extern "C" int sw_halo_launch(int is_f64, int npts, const void* traces, const void* src, const void* flip,
                              const void* conv, void* halo, void* stream) {
  if (npts < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (24 * npts + swk::kThreads - 1) / swk::kThreads;
  const int* sp = static_cast<const int*>(src);
  const int* fp = static_cast<const int*>(flip);
  if (is_f64)
    sw_halo_kernel<double><<<blocks, swk::kThreads, 0, st>>>(static_cast<const double*>(traces), sp, fp,
                                                            static_cast<const double*>(conv),
                                                            static_cast<double*>(halo), npts);
  else
    sw_halo_kernel<float><<<blocks, swk::kThreads, 0, st>>>(static_cast<const float*>(traces), sp, fp,
                                                           static_cast<const float*>(conv),
                                                           static_cast<float*>(halo), npts);
  return (int)cudaGetLastError();
}

extern "C" const char* sw_operator_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
