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
// sw_tangent_kernel has no TPU counterpart: the JAX package computes the
// Jacobian action J(q).v of its shallow-water RHS as jax.jvp of XLA
// (integrators/epi.py:126-128 there; its float32 companion's, of the absolute
// float32 operator, :197-200). It computes J(q).v of the absolute operator
// in one launch, whole sphere, the halos of q and v both taken from the
// state as the state mode takes q's (C entry sw_tangent_state_launch; plain
// version ops/sw_operator.py::sw_tangent_plain, torch.func.jvp of the plain
// operator; wrapper sw_tangent). Its flux tangent is swk::ausm_tangent.
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

// ---------------------------------------------------------------------------
// The Jacobian action J(q).v of the absolute operator (whole sphere, halos
// from the state), its own body rather than a mode of element_block, so the
// operator's instantiations keep their code. Shared memory (in T): the 1D
// factors, then per element [q (3 s^2) | v (3 s^2) | dfx, dfy (6 s^2) |
// face flux tangents (3 * 4s)].
template <int S>
struct TangentShape {
  static constexpr int S2 = S * S;
  static constexpr int NF = 4 * S;
  static constexpr int N_FAC = Shape<S>::N_FAC;
  static constexpr int PER_ELEM = 12 * S2 + 3 * NF;
  static constexpr int EB = swk::kThreads / S2 > 0 ? swk::kThreads / S2 : 1;
  static size_t smem_bytes(size_t item, int eb) { return item * (N_FAC + (size_t)eb * PER_ELEM); }
};

template <typename T>
struct TangentArgs {
  const T* q;  // the linearisation point
  const T* v;  // the direction
  const T* ops;
  const T* fields;
  const T* gridrot;
  const T* itf_x;
  const T* itf_y;
  const int* hsrc;
  const int* hflip;
  const T* hconv;
  T* out;
  int nel;
};

// One thread a node, eb elements a block, as the operator: the pointwise
// fluxes' and forcing's tangents by the product rule at each node; at each
// of the element's faces the own traces of q and v (face_trace of the
// element's nodes in shared memory) and the neighbour's (face_trace of its
// nodes in global memory, the same function and fma order its own face
// uses; at a panel edge state_halo_point, for q and for v alike, since the
// halo is linear), ordered (L, R) as the operator orders them, into one
// ausm_tangent call, so both sides of an interface get the same bits and
// J.v conserves mass to round-off; then the divergence and the correction
// in the operator's order.
template <typename T, int S>
__global__ void __launch_bounds__(swk::kThreads) sw_tangent_kernel(TangentArgs<T> A, int eb) {
  using Sh = TangentShape<S>;
  constexpr int S2 = Sh::S2, NF = Sh::NF;
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  swk::load_factors<T, S>(A.ops, smem);
  const T* sExt = smem;
  const T* sDx = sExt + NF;
  const T* sDy = sDx + S2;
  const T* sCorr = sDy + S2;

  const int nel = A.nel;
  const int tid = threadIdx.x;
  const int e_loc = tid / S2;
  const int j = tid - e_loc * S2;
  const int ky = j / S, kx = j - ky * S;
  const int per_panel = nel * nel;
  const int nelem = 6 * per_panel;
  const int elem = blockIdx.x * eb + e_loc;
  const bool valid = e_loc < eb && elem < nelem;
  const long long nq = (long long)nelem * S2;
  const long long fstride = (long long)per_panel * S2;
  const long long pt = (long long)elem * S2 + j;

  T* sQ = smem + Sh::N_FAC + e_loc * Sh::PER_ELEM;
  T* sV = sQ + 3 * S2;
  T* sF = sV + 3 * S2;
  T* sFl = sF + 6 * S2;

  int p = 0, pe = 0, ey = 0, ex = 0;
  if (valid) {
    p = elem / per_panel;
    pe = elem - p * per_panel;
    ey = pe / nel;
    ex = pe - ey * nel;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      sQ[v * S2 + j] = A.q[v * nq + pt];
      sV[v * S2 + j] = A.v[v * nq + pt];
    }
  }
  __syncthreads();

  T dforce1 = T(0), dforce2 = T(0), invsg = T(0);
  if (valid) {
    const T* fld = A.fields + (long long)pe * S2 + j;
    const T sqrtg = fld[0], h11 = fld[fstride], h12 = fld[2 * fstride], h22 = fld[3 * fstride];
    const T g101 = fld[4 * fstride], g102 = fld[5 * fstride];
    const T g201 = fld[6 * fstride], g202 = fld[7 * fstride];
    const T c111 = fld[8 * fstride], c112 = fld[9 * fstride];
    const T c212 = fld[10 * fstride], c222 = fld[11 * fstride];
    invsg = fld[12 * fstride];
    const T half_g = T(0.5 * swk::kGravity);
    const T rot2 = T(2) * A.gridrot[pt];
    const T h = sQ[j], hu1 = sQ[S2 + j], hu2 = sQ[2 * S2 + j];
    const T dh = sV[j], dhu1 = sV[S2 + j], dhu2 = sV[2 * S2 + j];
    const T u1 = hu1 / h, u2 = hu2 / h;
    const T du1 = (dhu1 - u1 * dh) / h;
    const T du2 = (dhu2 - u2 * dh) / h;
    const T dhsq = T(2) * h * dh;
    const T d11 = dhu1 * u1 + hu1 * du1;  // d(hu1 u1)
    const T d12 = dhu1 * u2 + hu1 * du2;  // d(hu1 u2)
    const T d21 = dhu2 * u1 + hu2 * du1;  // d(hu2 u1)
    const T d22 = dhu2 * u2 + hu2 * du2;  // d(hu2 u2)
    sF[0 * S2 + j] = sqrtg * dhu1;
    sF[1 * S2 + j] = sqrtg * (d11 + half_g * h11 * dhsq);
    sF[2 * S2 + j] = sqrtg * (d21 + half_g * h12 * dhsq);
    sF[3 * S2 + j] = sqrtg * dhu2;
    sF[4 * S2 + j] = sqrtg * (d12 + half_g * h12 * dhsq);
    sF[5 * S2 + j] = sqrtg * (d22 + half_g * h22 * dhsq);
    dforce1 = rot2 * (g101 * dhu1 + g102 * dhu2) + c111 * d11 + T(2) * c112 * d12;
    dforce2 = rot2 * (g201 * dhu1 + g202 * dhu2) + T(2) * c212 * d12 + c222 * d22;

    for (int fi = j; fi < NF; fi += S2) {
      const int side = fi / S;  // faces: 0 west, 1 east, 2 south, 3 north
      const int k = fi - side * S;
      bool at_edge;
      int nb_elem, hside, along;
      switch (side) {
        case 0: at_edge = ex == 0;       nb_elem = elem - 1;   hside = 2; along = ey; break;
        case 1: at_edge = ex == nel - 1; nb_elem = elem + 1;   hside = 3; along = ey; break;
        case 2: at_edge = ey == 0;       nb_elem = elem - nel; hside = 0; along = ex; break;
        default: at_edge = ey == nel - 1; nb_elem = elem + nel; hside = 1; along = ex; break;
      }
      const int nb_side = side ^ 1;
      T own[3], nb[3], down[3], dnb[3];
      if (at_edge) {
        swk::state_halo_point<T, S>(A.q, sExt, A.hsrc, A.hflip, A.hconv, nel, hside * 6 + p, along * S + k, nb);
        swk::state_halo_point<T, S>(A.v, sExt, A.hsrc, A.hflip, A.hconv, nel, hside * 6 + p, along * S + k, dnb);
      } else {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const long long at = v * nq + (long long)nb_elem * S2;
          nb[v] = swk::face_trace<T, S>(A.q + at, sExt + nb_side * S, nb_side, k);
          dnb[v] = swk::face_trace<T, S>(A.v + at, sExt + nb_side * S, nb_side, k);
        }
      }
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        own[v] = swk::face_trace<T, S>(sQ + v * S2, sExt + side * S, side, k);
        down[v] = swk::face_trace<T, S>(sV + v * S2, sExt + side * S, side, k);
      }
      const bool own_right = side == 0 || side == 2;
      T L[3], R[3], dL[3], dR[3], dF[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        L[v] = own_right ? nb[v] : own[v];
        R[v] = own_right ? own[v] : nb[v];
        dL[v] = own_right ? dnb[v] : down[v];
        dR[v] = own_right ? down[v] : dnb[v];
      }
      const bool is_x = side < 2;
      const T* itf = is_x ? A.itf_x : A.itf_y;
      const int istride = nel * (nel + 1) * S;
      const int iidx = is_x ? ((ey * (nel + 1) + ex + (side == 1)) * S + k)
                            : (((ey + (side == 3)) * nel + ex) * S + k);
      swk::ausm_tangent(L, R, dL, dR, itf[iidx], itf[istride + iidx], itf[2 * istride + iidx], is_x, dF);
#pragma unroll
      for (int v = 0; v < 3; ++v) sFl[v * NF + fi] = dF[v];
    }
  }
  __syncthreads();

  if (valid) {
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      T div = T(0);
#pragma unroll
      for (int m = 0; m < S; ++m) div = swk::fmadd(sF[v * S2 + ky * S + m], sDx[kx * S + m], div);
#pragma unroll
      for (int m = 0; m < S; ++m) div = swk::fmadd(sF[(3 + v) * S2 + m * S + kx], sDy[ky * S + m], div);
      T corr = T(0);
      corr = swk::fmadd(sFl[v * NF + ky], sCorr[kx], corr);                 // west
      corr = swk::fmadd(sFl[v * NF + S + ky], sCorr[S + kx], corr);         // east
      corr = swk::fmadd(sFl[v * NF + 2 * S + kx], sCorr[2 * S + ky], corr);  // south
      corr = swk::fmadd(sFl[v * NF + 3 * S + kx], sCorr[3 * S + ky], corr);  // north
      const T dforce = v == 0 ? T(0) : (v == 1 ? dforce1 : dforce2);
      A.out[v * nq + pt] = (-invsg * div - dforce) - invsg * corr;
    }
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

template <typename T, int S>
cudaError_t launch_tangent(const TangentArgs<T>& A, cudaStream_t stream) {
  using Sh = TangentShape<S>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int nelem = 6 * A.nel * A.nel;
  const int eb = elements_per_block(nelem, Sh::EB, sms);
  const int blocks = (nelem + eb - 1) / eb;
  sw_tangent_kernel<T, S><<<blocks, eb * Sh::S2, Sh::smem_bytes(sizeof(T), eb), stream>>>(A, eb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tangent(int s, int nel, const void* q, const void* v, const void* ops, const void* fields,
                             const void* gridrot, const void* itf_x, const void* itf_y, const void* src,
                             const void* flip, const void* conv, void* out, cudaStream_t stream) {
  TangentArgs<T> A{};
  A.q = static_cast<const T*>(q);
  A.v = static_cast<const T*>(v);
  A.ops = static_cast<const T*>(ops);
  A.fields = static_cast<const T*>(fields);
  A.gridrot = static_cast<const T*>(gridrot);
  A.itf_x = static_cast<const T*>(itf_x);
  A.itf_y = static_cast<const T*>(itf_y);
  A.hsrc = static_cast<const int*>(src);
  A.hflip = static_cast<const int*>(flip);
  A.hconv = static_cast<const T*>(conv);
  A.out = static_cast<T*>(out);
  A.nel = nel;
#define SW_CASE(S) \
  case S:          \
    return launch_tangent<T, S>(A, stream);
  switch (s) {
    SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5) SW_CASE(6) SW_CASE(7) SW_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef SW_CASE
}

template <typename T>
cudaError_t tangent_resources(int s, int* info) {
#define SW_CASE(S)                                                                                    \
  case S:                                                                                             \
    return swk::kernel_resources(sw_tangent_kernel<T, S>, TangentShape<S>::EB * TangentShape<S>::S2, \
                                 TangentShape<S>::smem_bytes(sizeof(T), TangentShape<S>::EB), info);
  switch (s) {
    SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5) SW_CASE(6) SW_CASE(7) SW_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef SW_CASE
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

// J(q).v of the absolute operator, whole sphere, the halos of q and v both
// taken from the state (the halo tables src, flip, conv of the state mode):
// q, v, out (3, 6*nel*nel, s^2); the other arguments as for
// sw_operator_state_launch.
extern "C" int sw_tangent_state_launch(int is_f64, int s, int nel, const void* q, const void* v, const void* ops,
                                       const void* fields, const void* gridrot, const void* itf_x,
                                       const void* itf_y, const void* src, const void* flip, const void* conv,
                                       void* out, void* stream) {
  if (nel < 2 || q == nullptr || v == nullptr || src == nullptr || flip == nullptr || conv == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? dispatch_tangent<double>(s, nel, q, v, ops, fields, gridrot, itf_x, itf_y, src, flip, conv,
                                                 out, st)
                      : dispatch_tangent<float>(s, nel, q, v, ops, fields, gridrot, itf_x, itf_y, src, flip, conv,
                                                out, st));
}

// The same report of the tangent kernel at (is_f64, s), at its largest block.
extern "C" int sw_tangent_resources(int is_f64, int s, int* info) {
  return (int)(is_f64 ? tangent_resources<double>(s, info) : tangent_resources<float>(s, info));
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
