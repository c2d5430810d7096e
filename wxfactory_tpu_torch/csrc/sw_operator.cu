// Shallow-water DFR spatial operator on the cubed sphere, one launch per call,
// and the two small kernels of the halo glue that its whole-sphere launch
// folds into its panel-edge faces.
//
// sw_operator_kernel replaces the TPU kernels wxfactory_tpu/ops/pallas_sw_gen.py::
// km_gen (body _panel_body, with pallas_sw._element_stage and _ausm_slots) and,
// for s=4, pallas_sw.py::km_fused: absolute form or, with the base planes
// (PERT), the perturbation form (_element_stage_pert, _ausm_delta_slots, the
// float64 base RHS added last); optional RK stage combination a*x + b*q +
// cdt*RHS(q); optional emission of the output's panel-edge traces. Its body is
// swk::element_block (csrc/sw_element.cuh). A whole-sphere call takes its
// panel-edge neighbours either from a halo plane (C entry sw_operator_launch)
// or, with no halo (sw_operator_state_launch), straight from the neighbour
// panels' rows of the input state: each panel-edge face point computes what
// the edge-trace kernel and then the halo kernel would have given it
// (swk::state_halo_point), so one launch does the work of three. The plain
// torch version of the same function is wxfactory_tpu_torch/ops/sw_operator.py::
// sw_operator_plain (sw_operator_pert_plain); the wrapper sw_operator there
// launches this kernel.
//
// The same kernel with a panel count of 1 (C entry sw_tile_launch) replaces
// pallas_sw_gen.py::km_tile, the per-rank kernel of the tile-parallel step
// (parallel/shard_map_sw_fused.py): one nt x nt tile of one panel whose four
// edges all take the halo, with the tile's own metric slice and gridrot. A
// tile edge inside a panel then behaves as a panel edge does: the halo holds
// the neighbour tile's emitted trace, computed in the same fma order as the
// re-extrapolation the whole-sphere launch does there. Plain version:
// ops/sw_operator.py::sw_tile_operator_plain; wrapper: sw_tile_operator.
//
// sw_edges_kernel replaces pallas_sw.py::ke_edges: the panel-edge traces
// (3, 4, 6, nel, s) of a state (plain version: ops/sw_operator.py::
// edge_traces). sw_halo_kernel replaces pallas_sw.py::kh_exchange: neighbour
// permutation, edge flips and the 2x2 contravariant rotation of the momenta,
// traces in, halo out (plain version: halo_from_traces). Both serve every
// (nel, s), and the halo is linear, so the same kernel takes absolute and
// delta traces. They run at setup (the perturbation base's halo) and as the
// standalone counterparts of the state mode's panel-edge faces, which call
// the same device functions (swk::edge_trace, swk::rotate_halo).
//
// Layouts: csrc/sw_element.cuh.
//
// Design: one thread per solution point, up to EB = 256 / s^2 elements per
// block; the sum-factorised body of sw_element.cuh (only the 1D factors, 8s +
// 2s^2 words, are shared by the block; each element keeps its state,
// pointwise fluxes and face fluxes in shared memory: 23 KB a block at s=7
// float64, where the dense EE/DD/CC blocks took 79.5 KB). A launch with too
// few elements to give every SM a block (a tile: nt = 32, s = 3) takes fewer
// elements a block (elements_per_block). In the perturbation form the base
// planes are read from global memory per thread (the node's h0, hu0, u0,
// rhs0 and the faces' base traces and halo), so the shared memory of a block
// does not grow.
//
// What bounds it (H100 SXM, s=3, float64, per element and call): about
// 0.7-0.9 KB of device-memory traffic (state 216 B in and 216 B out, x 216 B
// in stage mode, gridrot 72 B; the single-panel metric, 13 fields, and the
// neighbours' rows mostly hit L2) against about 1.3 kFLOP (the s-term
// products, pointwise fluxes, 12 AUSM fluxes): under the card's f64 balance
// of ~10 FLOP/B (34 TFLOP/s vector f64 over 3.35 TB/s), so memory-bound in
// principle; at nel=64 both bounds are under 10 us, and block-level latency
// (two or three barriers a block, the face loop's dependent loads, square
// roots and divides) sets the time: skipping the face loop takes 47 % off
// the (64,3) float64 RHS, reading the neighbours' rows 9 %, the metric 11 %
// (tools/sw_operator_ablation.py). The perturbation form reads 14 base
// planes more (about 2.3x the state's bytes) and does about twice the face
// work. The halo and edge kernels move a few hundred KB and are bound by
// their launch; the state mode's panel-edge faces read 3s words more each
// (4 nel of nel^2 elements a panel, the neighbour rows an L2 hit as the
// interior ones are) and write no traces.

#include <cuda_runtime.h>

#include <type_traits>

#include "sw_element.cuh"

namespace {

using swk::OpArgs;
using swk::Shape;

using swk::HaloFrom;

template <typename T, int S, bool PERT, HaloFrom HALO>
__device__ __forceinline__ void operator_body(const OpArgs<T>& A, int eb) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  swk::load_factors<T, S>(A.ops, smem);
  swk::element_block<T, S, PERT, HALO>(A, blockIdx.x, eb, smem);
}

template <typename T, int S, bool PERT, HaloFrom HALO>
__global__ void __launch_bounds__(swk::kThreads) sw_operator_kernel(OpArgs<T> A, int eb) {
  operator_body<T, S, PERT, HALO>(A, eb);
}

// The float32 perturbation form compiled for 4 resident blocks an SM (64
// registers; it takes 79 at s=4 and 3 blocks uncapped, and runs 15-17 %
// faster capped at s=4 and 7). A cap written into the other forms'
// template (a minimum of 1 block) made the absolute forms 3-20 % slower.
template <int S, HaloFrom HALO>
__global__ void __launch_bounds__(swk::kThreads, 4) sw_operator_f32_pert_kernel(OpArgs<float> A, int eb) {
  operator_body<float, S, true, HALO>(A, eb);
}

template <typename T, int S, bool PERT, HaloFrom HALO>
auto operator_kernel() {
  if constexpr (std::is_same<T, float>::value && PERT)
    return sw_operator_f32_pert_kernel<S, HALO>;
  else
    return sw_operator_kernel<T, S, PERT, HALO>;
}

template <typename T, int S>
__global__ void __launch_bounds__(swk::kThreads) sw_edges_kernel(const T* __restrict__ q, const T* __restrict__ ops,
                                                                 T* __restrict__ traces, int nel) {
  __shared__ T fac[Shape<S>::N_FAC];
  swk::load_factors<T, S>(ops, fac);
  __syncthreads();
  const long long total = 3LL * 24 * nel * S;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total; t += (long long)gridDim.x * blockDim.x)
    traces[t] = swk::trace_point<T, S>(q, fac, nel, t);
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

// Elements a block: Shape::EB, or fewer where the launch has too few
// elements to give every SM a block (a tile launch: nt = 32, s = 3 is 37
// blocks of 28 elements, 147 of 7).
int elements_per_block(int nelem, int eb_max, int sms) {
  const int eb = nelem / sms;
  return eb < 1 ? 1 : (eb < eb_max ? eb : eb_max);
}

template <typename T, int S, bool PERT, HaloFrom HALO>
cudaError_t launch_operator(const OpArgs<T>& A, cudaStream_t stream) {
  using Sh = Shape<S>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int nelem = A.npanel * A.nel * A.nel;
  const int eb = elements_per_block(nelem, Sh::EB, sms);
  const int blocks = (nelem + eb - 1) / eb;
  auto kernel = operator_kernel<T, S, PERT, HALO>();
  kernel<<<blocks, eb * Sh::S2, Sh::smem_bytes(sizeof(T), eb), stream>>>(A, eb);
  return cudaGetLastError();
}

template <typename T, int S>
cudaError_t launch_operator(const OpArgs<T>& A, bool pert, bool state, cudaStream_t stream) {
  if (state)
    return pert ? launch_operator<T, S, true, HaloFrom::kState>(A, stream)
                : launch_operator<T, S, false, HaloFrom::kState>(A, stream);
  return pert ? launch_operator<T, S, true, HaloFrom::kPlane>(A, stream)
              : launch_operator<T, S, false, HaloFrom::kPlane>(A, stream);
}

template <typename T>
cudaError_t dispatch_operator(int s, const OpArgs<T>& A, bool pert, bool state, cudaStream_t stream) {
#define SW_CASE(S) \
  case S:          \
    return launch_operator<T, S>(A, pert, state, stream);
  switch (s) {
    SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5) SW_CASE(6) SW_CASE(7) SW_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef SW_CASE
}

// What the runtime reports of the operator kernel's instantiation at its
// largest block (Shape::EB elements).
template <typename T, int S, bool PERT, HaloFrom HALO>
cudaError_t operator_resources(int* info) {
  using Sh = Shape<S>;
  return swk::kernel_resources(operator_kernel<T, S, PERT, HALO>(), Sh::EB * Sh::S2,
                               Sh::smem_bytes(sizeof(T), Sh::EB), info);
}

template <typename T, int S>
cudaError_t operator_resources(bool pert, bool state, int* info) {
  if (state)
    return pert ? operator_resources<T, S, true, HaloFrom::kState>(info)
                : operator_resources<T, S, false, HaloFrom::kState>(info);
  return pert ? operator_resources<T, S, true, HaloFrom::kPlane>(info)
              : operator_resources<T, S, false, HaloFrom::kPlane>(info);
}

template <typename T>
cudaError_t dispatch_resources(int s, bool pert, bool state, int* info) {
#define SW_CASE(S) \
  case S:          \
    return operator_resources<T, S>(pert, state, info);
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
OpArgs<T> op_args(int nel, int npanel, const void* q, const void* halo, const void* ops, const void* fields,
                  const void* gridrot, const void* itf_x, const void* itf_y, const void* x,
                  const void* q0, const void* u0, const void* itf0, const void* halo0, const void* rhs0,
                  const void* src, const void* flip, const void* conv, void* out, void* traces, double a, double b,
                  double cdt, int stage) {
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
  A.hsrc = static_cast<const int*>(src);
  A.hflip = static_cast<const int*>(flip);
  A.hconv = static_cast<const T*>(conv);
  A.nel = nel;
  A.npanel = npanel;
  A.a = T(a);
  A.b = T(b);
  A.cdt = T(cdt);
  A.stage = stage;
  return A;
}

// halo == nullptr: the state mode (whole sphere; src, flip and conv given).
int operator_launch(int npanel, int is_f64, int s, int nel, const void* q, const void* halo, const void* ops,
                    const void* fields, const void* gridrot, const void* itf_x, const void* itf_y, const void* x,
                    const void* q0, const void* u0, const void* itf0, const void* halo0, const void* rhs0,
                    const void* src, const void* flip, const void* conv, void* out, void* traces, double a,
                    double b, double cdt, int stage, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pert = q0 != nullptr;
  const bool state = halo == nullptr;
  if (pert && (u0 == nullptr || itf0 == nullptr || halo0 == nullptr || rhs0 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (state && (npanel != 6 || src == nullptr || flip == nullptr || conv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      is_f64 ? dispatch_operator<double>(s, op_args<double>(nel, npanel, q, halo, ops, fields, gridrot, itf_x, itf_y,
                                                            x, q0, u0, itf0, halo0, rhs0, src, flip, conv, out,
                                                            traces, a, b, cdt, stage),
                                         pert, state, st)
             : dispatch_operator<float>(s, op_args<float>(nel, npanel, q, halo, ops, fields, gridrot, itf_x, itf_y,
                                                          x, q0, u0, itf0, halo0, rhs0, src, flip, conv, out,
                                                          traces, a, b, cdt, stage),
                                        pert, state, st);
  return (int)err;
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
  if (nel < 2 || halo == nullptr) return (int)cudaErrorInvalidValue;
  return operator_launch(6, is_f64, s, nel, q, halo, ops, fields, gridrot, itf_x, itf_y, x, q0, u0, itf0, halo0,
                         rhs0, nullptr, nullptr, nullptr, out, traces, a, b, cdt, stage, stream);
}

// The same operator with no halo (the state mode): each panel-edge face
// takes its neighbour's values from the neighbour panel's rows of q,
// exchanged and rotated with the halo tables src, flip (24) int32 and conv
// (4, 24, nel*s) of sw_halo_launch; the perturbation form reads the delta
// neighbour from q and the base halo from halo0. One launch computes what
// sw_edges_launch, sw_halo_launch and sw_operator_launch compute in turn,
// bit for bit.
extern "C" int sw_operator_state_launch(int is_f64, int s, int nel, const void* q, const void* ops,
                                        const void* fields, const void* gridrot, const void* itf_x,
                                        const void* itf_y, const void* x, const void* q0, const void* u0,
                                        const void* itf0, const void* halo0, const void* rhs0, const void* src,
                                        const void* flip, const void* conv, void* out, void* traces, double a,
                                        double b, double cdt, int stage, void* stream) {
  if (nel < 2) return (int)cudaErrorInvalidValue;
  return operator_launch(6, is_f64, s, nel, q, nullptr, ops, fields, gridrot, itf_x, itf_y, x, q0, u0, itf0, halo0,
                         rhs0, src, flip, conv, out, traces, a, b, cdt, stage, stream);
}

// The same operator over ONE tile of nt x nt elements (the port of
// pallas_sw_gen.py::km_tile): the layouts above with one panel, so q, x, out
// (3, nt*nt, s^2), halo and traces (3, 4, 1, nt, s) on all four tile edges,
// fields (13, nt*nt, s^2) and gridrot (nt*nt, s^2) the tile's slices, itf_x
// (3, nt, nt+1, s) and itf_y (3, nt+1, nt, s) the tile's interfaces; base
// planes likewise.
extern "C" int sw_tile_launch(int is_f64, int s, int nt, const void* q, const void* halo,
                              const void* ops, const void* fields, const void* gridrot,
                              const void* itf_x, const void* itf_y, const void* x, const void* q0,
                              const void* u0, const void* itf0, const void* halo0, const void* rhs0,
                              void* out, void* traces, double a, double b, double cdt, int stage,
                              void* stream) {
  if (nt < 1 || halo == nullptr) return (int)cudaErrorInvalidValue;
  return operator_launch(1, is_f64, s, nt, q, halo, ops, fields, gridrot, itf_x, itf_y, x, q0, u0, itf0, halo0,
                         rhs0, nullptr, nullptr, nullptr, out, traces, a, b, cdt, stage, stream);
}

// Panel-edge traces (3, 4, 6, nel, s) of q; ops as for sw_operator_launch
// (the kernel reads the 1D factors from it).
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

// What the runtime reports of the operator kernel at (is_f64, s, pert), halo
// plane: info = [registers, local (spill) bytes a thread, dynamic shared
// memory bytes a block, resident blocks an SM, threads a block], at its
// largest block.
extern "C" int sw_operator_resources(int is_f64, int s, int pert, int* info) {
  return (int)(is_f64 ? dispatch_resources<double>(s, pert != 0, false, info)
                      : dispatch_resources<float>(s, pert != 0, false, info));
}

// The same of the state mode's instantiation.
extern "C" int sw_operator_state_resources(int is_f64, int s, int pert, int* info) {
  return (int)(is_f64 ? dispatch_resources<double>(s, pert != 0, true, info)
                      : dispatch_resources<float>(s, pert != 0, true, info));
}

extern "C" const char* sw_operator_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
