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
// sw_tangent_prep_kernel and sw_tangent_apply_kernel have no TPU
// counterpart: the JAX package computes the Jacobian action J(q).v of its
// shallow-water RHS as jax.jvp of XLA (integrators/epi.py:126-128 there; its
// float32 companion's, of the absolute float32 operator, :197-200). They
// compute J(q).v of the absolute operator, whole sphere, the panel-edge
// values of q and v both taken from the state as the state mode takes q's,
// in two launches because q is fixed for a whole Krylov solve: the prep
// (C entry sw_tangent_prep_launch) once per linearisation point writes every
// primal quantity of the action that costs a square root, a division or a
// trace of q into a coefficient buffer (per node h, u1, u2; per interface
// point, once for both sides, the two traces and the AUSM flux's primal
// coefficients, swk::ausm_tangent_coefficients); the apply
// (sw_tangent_apply_launch) once per direction reads v and the buffer and is
// linear in v (swk::ausm_tangent_apply). Plain versions: ops/sw_operator.py::
// sw_tangent_prep_plain and sw_tangent_apply_plain (the split in torch), and
// sw_tangent_plain (torch.func.jvp of the plain operator, the function);
// wrappers sw_tangent_prep, sw_tangent_apply and sw_tangent (the two in one
// call).
//
// Bottom topography (Williamson cases 5 and 10): the state mode's absolute
// form (C entry sw_operator_state_topo_launch, sw_operator_topo_kernel), its
// perturbation form (sw_operator_state_pert_topo_launch,
// sw_operator_pert_topo_kernel and, float32, sw_operator_f32_pert_topo_kernel:
// the base planes carry the topography's traces, the kernel reads the two
// forcing coefficients) and
// the tangent pair (sw_tangent_prep_topo_launch, sw_tangent_apply_topo_launch)
// take four more planes (csrc/sw_element.cuh: hsurf at the nodes and at the
// interfaces, the two forcing coefficients). Each is the same body with its
// TOPO branch compiled in, a kernel of its own, so the kernels without
// topography keep their code; a topo entry given null planes launches those.
// The prep extrapolates h + hsurf and subtracts the interface's hsurf before
// the flux coefficients (hsurf does not enter dh, so the buffer's layout
// stays); the apply adds each forcing coefficient times dh, two more words a
// node. Plain versions: ops/sw_operator.py, the same functions with ``topo``.
//
// The tangent pair also runs at s = 1 (the pure finite-volume levels of the
// fv-mg preconditioner: no derivative, the face traces the node value, only
// the interface fluxes).
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
// What bounds the operator (s=3, float64, per element and call): about
// 0.7-0.9 KB of device-memory traffic (state 216 B in and 216 B out, x 216 B
// in stage mode, gridrot 72 B; the single-panel metric, 13 fields, and the
// neighbours' rows mostly hit L2) against about 1.3 kFLOP (the s-term
// products, pointwise fluxes, 12 AUSM fluxes): under the card's f64 balance
// of ~10 FLOP/B (34 TFLOP/s vector f64 over 3.35 TB/s), so memory-bound in
// principle; at nel=64 both bounds are under 10 us, and block-level latency
// (two or three barriers a block, the face loop's dependent loads, square
// roots and divides) sets the time: skipping the face loop takes 47 % off
// the (64,3) float64 RHS, reading the neighbours' rows 9 %, the metric 11 %
// (tools/sw_operator_ablation.py on an NVIDIA H100 80GB HBM3 at its 700 W
// power limit). The perturbation form reads 14 base
// planes more (about 2.3x the state's bytes) and does about twice the face
// work. The halo and edge kernels move a few hundred KB and are bound by
// their launch; the state mode's panel-edge faces read 3s words more each
// (4 nel of nel^2 elements a panel, the neighbour rows an L2 hit as the
// interior ones are) and write no traces.
//
// What bounds the tangent pair (NVIDIA H100 80GB HBM3, 700 W power limit;
// tools/sw_operator_ablation.py, in turns with the one-call J.v kernel the
// pair replaced, which recomputed every face's square roots and divisions
// and re-read q's neighbour traces on every J.v). At (64,3) float64 the
// apply takes 0.0235-0.0241 ms (the one-call kernel 0.0353-0.0355), against
// the function's bytes bound 0.0066 ms and its own floor 0.0113 (37.9 MB:
// the buffer is 3 words a node and 13 an interface point, each interface
// read from both sides); half of it is the face loop (0.0116 without it),
// of which the neighbours' direction traces are 0.0027 and the coefficient
// reads 0.0020: latency and issue rather than bytes. 78-80 registers and 3
// blocks of 256 threads an SM in float64 at s <= 6 (a cap for 3 blocks
// gains nothing). The prep, once a linearisation point, takes 0.0119-0.0125
// ms (its own floor 0.0079). At (10,3) both are latency: 0.0050-0.0052 and
// 0.0060-0.0063 ms, 150 blocks of 64 threads. Computing each x interface
// inside a block once for both of its elements measured slower (0.0300 ms
// at (64,3) float64: 94-108 registers, 2 blocks an SM).

#include <cuda_runtime.h>

#include <type_traits>

#include "sw_element.cuh"

namespace {

using swk::OpArgs;
using swk::Shape;

using swk::HaloFrom;

template <typename T, int S, bool PERT, HaloFrom HALO, bool TOPO = false>
__device__ __forceinline__ void operator_body(const OpArgs<T>& A, int eb) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  swk::load_factors<T, S>(A.ops, smem);
  swk::element_block<T, S, PERT, HALO, TOPO>(A, blockIdx.x, eb, smem);
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

// The absolute state mode with bottom topography.
template <typename T, int S>
__global__ void __launch_bounds__(swk::kThreads) sw_operator_topo_kernel(OpArgs<T> A, int eb) {
  operator_body<T, S, false, HaloFrom::kState, true>(A, eb);
}

// The perturbation form's state mode with bottom topography (the float32
// companion and the float32 production point of Williamson cases 5 and 10):
// the PERT body with the forcing delta of the topography, kernels of their
// own so that neither the perturbation kernels without topography nor the
// absolute topography kernel change. Float32 is capped at 4 resident blocks
// an SM as the perturbation form without topography is: uncapped it takes
// 74 registers at s=3 and 3 blocks, and runs 24-26 % slower than the kernel
// without topography at (64,3); capped, 64 registers and no spill, 2-3 %
// (tools/sw_operator_ablation.py, NVIDIA H100 80GB HBM3 at 700 W).
template <typename T, int S>
__global__ void __launch_bounds__(swk::kThreads) sw_operator_pert_topo_kernel(OpArgs<T> A, int eb) {
  operator_body<T, S, true, HaloFrom::kState, true>(A, eb);
}

template <int S>
__global__ void __launch_bounds__(swk::kThreads, 4) sw_operator_f32_pert_topo_kernel(OpArgs<float> A, int eb) {
  operator_body<float, S, true, HaloFrom::kState, true>(A, eb);
}

template <typename T, int S, bool PERT, HaloFrom HALO, bool TOPO = false>
auto operator_kernel() {
  if constexpr (TOPO && PERT && std::is_same<T, float>::value)
    return sw_operator_f32_pert_topo_kernel<S>;
  else if constexpr (TOPO && PERT)
    return sw_operator_pert_topo_kernel<T, S>;
  else if constexpr (TOPO)
    return sw_operator_topo_kernel<T, S>;
  else if constexpr (std::is_same<T, float>::value && PERT)
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
// from the state), split in two kernels because q is fixed for a whole
// Krylov solve and v changes every iteration: the prep once per
// linearisation point writes the coefficient buffer, the apply once per
// direction reads it and is linear in v. Their own bodies rather than modes
// of element_block, so the operator's instantiations keep their code.
//
// The coefficient buffer (ops/sw_operator.py::sw_tangent_layout), rows in
// the order of SW_TANGENT_NODE_ROWS and SW_TANGENT_FACE_ROWS there:
//   node    (3, 6*nel*nel, s^2)        h, u1 = hu1/h, u2 = hu2/h
//   face_x  (13, 6, nel, nel+1, s)     per x1 interface point of each panel
//   face_y  (13, 6, nel+1, nel, s)     per x2 interface point of each panel
// An interface is m = 0..nel along its row (x) or column (y) of a panel, as
// in the interface metric (itf_x, itf_y, with a panel index in front): L is
// element m-1's east (north) face, R element m's west (south) face, and the
// panel-edge interfaces m = 0 (L) and m = nel (R) take the halo.
template <typename T>
struct TangentArgs {
  const T* q;     // prep: the linearisation point
  const T* v;     // apply: the direction
  const T* coef;  // apply: the prep's buffer
  const T* ops;
  const T* fields;
  const T* gridrot;
  const T* itf_x;
  const T* itf_y;
  const int* hsrc;
  const int* hflip;
  const T* hconv;
  T* out;  // prep: the buffer; apply: J.v
  int nel;
};

// Bottom topography of the tangent kernels with topography: the prep's
// hsurf, hsurf_x, hsurf_y, the apply's force; a kernel parameter of those
// kernels only. Four more pointers in TangentArgs cost the apply without
// topography 17 registers and a block an SM (95 against 78 at s = 3 f64:
// 0.0270 against 0.0238 ms at (64,3), NVIDIA H100 80GB HBM3, 700 W;
// tools/sw_operator_ablation.py --source, in turns with the kernel before).
template <typename T>
struct TangentTopo {
  const T* hsurf;
  const T* hsurf_x;
  const T* hsurf_y;
  const T* force;
};

// Offsets of the buffer's parts, in T: a node row is nq long, a face row of
// either family nx.
struct TangentLayout {
  long long nq, nx;
  __host__ __device__ TangentLayout(int nel, int s)
      : nq(6LL * nel * nel * s * s), nx(6LL * nel * (nel + 1) * s) {}
  __host__ __device__ long long face(bool is_x) const { return 3 * nq + (is_x ? 0 : swk::kTangentFaceRows * nx); }
  __host__ __device__ long long size() const { return 3 * nq + 2 * swk::kTangentFaceRows * nx; }
};

// One thread an item: a node (its three node rows) or an interface point
// (both traces of q, then ausm_tangent_coefficients). Each trace of q is
// face_trace of its element's nodes in global memory, the function and fma
// order the operator uses for an element's own face and for its neighbour's
// re-extrapolation; a panel-edge interface takes its halo value from
// state_halo_point, as the operator's state mode does. TOPO: h's traces are
// those of h + hsurf, less the interface's hsurf on both sides.
template <typename T, int S, bool TOPO>
__device__ __forceinline__ void tangent_prep_body(const TangentArgs<T>& A, const TangentTopo<T>& P) {
  constexpr int S2 = S * S;
  __shared__ T fac[Shape<S>::N_FAC];
  swk::load_factors<T, S>(A.ops, fac);
  __syncthreads();
  const int nel = A.nel;
  const TangentLayout lay(nel, S);
  const long long nq = lay.nq, nx = lay.nx;
  const long long total = nq + 2 * nx;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    if (t < nq) {
      const T h = A.q[t], hu1 = A.q[nq + t], hu2 = A.q[2 * nq + t];
      A.out[t] = h;
      A.out[nq + t] = hu1 / h;
      A.out[2 * nq + t] = hu2 / h;
      continue;
    }
    const bool is_x = t < nq + nx;
    const long long i = is_x ? t - nq : t - nq - nx;
    const int k = (int)(i % S);
    long long r = i / S;
    int p, m, along, iidx;
    // Elements left and right of the interface, their faces, and the halo
    // rows of the panel-edge interfaces.
    long long el_l, el_r;
    int f_l, f_r, hrow_l, hrow_r;
    if (is_x) {
      m = (int)(r % (nel + 1));
      r /= nel + 1;
      along = (int)(r % nel);  // ey
      p = (int)(r / nel);
      const long long row0 = ((long long)p * nel + along) * nel;
      el_l = row0 + m - 1;
      el_r = row0 + m;
      f_l = 1;
      f_r = 0;
      hrow_l = 2 * 6 + p;  // west
      hrow_r = 3 * 6 + p;  // east
      iidx = (along * (nel + 1) + m) * S + k;
    } else {
      along = (int)(r % nel);  // ex
      r /= nel;
      m = (int)(r % (nel + 1));
      p = (int)(r / (nel + 1));
      el_l = ((long long)p * nel + m - 1) * nel + along;
      el_r = ((long long)p * nel + m) * nel + along;
      f_l = 3;
      f_r = 2;
      hrow_l = 0 * 6 + p;  // south
      hrow_r = 1 * 6 + p;  // north
      iidx = (m * nel + along) * S + k;
    }
    T L[3], R[3], c[swk::kTangentFaceRows];
    if (m == 0) {
      swk::state_halo_point<T, S, TOPO>(A.q, fac, A.hsrc, A.hflip, A.hconv, nel, hrow_l, along * S + k, L, P.hsurf);
    } else {
#pragma unroll
      for (int v = 0; v < 3; ++v) L[v] = swk::face_trace<T, S>(A.q + v * nq + el_l * S2, fac + f_l * S, f_l, k);
      if constexpr (TOPO) L[0] = swk::face_trace_sum<T, S>(A.q + el_l * S2, P.hsurf + el_l * S2, fac + f_l * S, f_l, k);
    }
    if (m == nel) {
      swk::state_halo_point<T, S, TOPO>(A.q, fac, A.hsrc, A.hflip, A.hconv, nel, hrow_r, along * S + k, R, P.hsurf);
    } else {
#pragma unroll
      for (int v = 0; v < 3; ++v) R[v] = swk::face_trace<T, S>(A.q + v * nq + el_r * S2, fac + f_r * S, f_r, k);
      if constexpr (TOPO) R[0] = swk::face_trace_sum<T, S>(A.q + el_r * S2, P.hsurf + el_r * S2, fac + f_r * S, f_r, k);
    }
    if constexpr (TOPO) {
      // i is the interface point's flat index in hsurf_x (6, nel, nel+1, s) or hsurf_y (6, nel+1, nel, s).
      const T hs = (is_x ? P.hsurf_x : P.hsurf_y)[i];
      L[0] = L[0] - hs;
      R[0] = R[0] - hs;
    }
    const T* itf = is_x ? A.itf_x : A.itf_y;
    const int istride = nel * (nel + 1) * S;
    swk::ausm_tangent_coefficients(L, R, itf[istride + iidx], is_x, c);
    T* dst = A.out + lay.face(is_x) + i;
#pragma unroll
    for (int row = 0; row < swk::kTangentFaceRows; ++row) dst[row * nx] = c[row];
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(swk::kThreads) sw_tangent_prep_kernel(TangentArgs<T> A) {
  tangent_prep_body<T, S, false>(A, TangentTopo<T>{});
}

template <typename T, int S>
__global__ void __launch_bounds__(swk::kThreads) sw_tangent_prep_topo_kernel(TangentArgs<T> A, TangentTopo<T> P) {
  tangent_prep_body<T, S, true>(A, P);
}

// Up to Shape::EB elements a block as the operator, one thread a node, the
// block rounded up to whole warps. The pointwise fluxes' and forcing's
// tangents at each node from the node rows by the product rule (h du =
// dhu - u dh: d(hu_a u_b) = dhu_a u_b + u_a (dhu_b - u_b dh)); then the
// block's face points, face by face over its elements, so every thread of
// the block, the warp's padding included, takes at most ceil(4 eb s /
// threads) of them: the direction's own trace (face_trace of its nodes in
// shared memory) and the neighbour's (face_trace of its nodes in global
// memory, the same function and fma order its own face uses; at a panel edge
// state_halo_point of v, the halo being linear), ordered (L, R) as the
// operator orders them, into one ausm_tangent_apply call on the interface's
// stored coefficients, so both sides of an interface get the same bits and
// J.v conserves mass to round-off; then the divergence and the correction in
// the operator's order. Shared memory (in T) as the operator's: the 1D
// factors, then per element [v (3 s^2) | dfx, dfy (6 s^2) | face flux
// tangents (3 * 4s)]. TOPO: the forcing rows add force * dh.
template <typename T, int S, bool TOPO>
__device__ __forceinline__ void tangent_apply_body(const TangentArgs<T>& A, const TangentTopo<T>& P, int eb) {
  using Sh = Shape<S>;
  constexpr int S2 = Sh::S2, NF = Sh::NF;
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  swk::load_factors<T, S>(A.ops, smem);
  const T* sExt = smem;
  const T* sDx = sExt + NF;
  const T* sDy = sDx + S2;
  const T* sCorr = sDy + S2;

  const int nel = A.nel;
  const TangentLayout lay(nel, S);
  const int tid = threadIdx.x;
  const int e_loc = tid / S2;
  const int j = tid - e_loc * S2;
  const int ky = j / S, kx = j - ky * S;
  const int per_panel = nel * nel;
  const int nelem = 6 * per_panel;
  const int elem0 = blockIdx.x * eb;
  const int elem = elem0 + e_loc;
  const bool valid = e_loc < eb && elem < nelem;
  const long long nq = lay.nq;
  const long long fstride = (long long)per_panel * S2;
  const long long pt = (long long)elem * S2 + j;
  T* sV = smem + Sh::N_FAC + e_loc * Sh::PER_ELEM;  // dereferenced only where valid
  T* sF = sV + 3 * S2;

  T dforce1 = T(0), dforce2 = T(0), invsg = T(0);
  if (valid) {
    const T dh = A.v[pt], dhu1 = A.v[nq + pt], dhu2 = A.v[2 * nq + pt];
    sV[j] = dh;
    sV[S2 + j] = dhu1;
    sV[2 * S2 + j] = dhu2;
    const T h = A.coef[pt], u1 = A.coef[nq + pt], u2 = A.coef[2 * nq + pt];
    const T* fld = A.fields + (long long)(elem % per_panel) * S2 + j;
    const T sqrtg = fld[0], h11 = fld[fstride], h12 = fld[2 * fstride], h22 = fld[3 * fstride];
    const T g101 = fld[4 * fstride], g102 = fld[5 * fstride];
    const T g201 = fld[6 * fstride], g202 = fld[7 * fstride];
    const T c111 = fld[8 * fstride], c112 = fld[9 * fstride];
    const T c212 = fld[10 * fstride], c222 = fld[11 * fstride];
    invsg = fld[12 * fstride];
    const T half_g = T(0.5 * swk::kGravity);
    const T rot2 = T(2) * A.gridrot[pt];
    const T w1 = dhu1 - u1 * dh, w2 = dhu2 - u2 * dh;  // h du1, h du2
    const T dhsq = T(2) * h * dh;
    const T d11 = dhu1 * u1 + u1 * w1;  // d(hu1 u1)
    const T d12 = dhu1 * u2 + u1 * w2;  // d(hu1 u2)
    const T d21 = dhu2 * u1 + u2 * w1;  // d(hu2 u1)
    const T d22 = dhu2 * u2 + u2 * w2;  // d(hu2 u2)
    sF[0 * S2 + j] = sqrtg * dhu1;
    sF[1 * S2 + j] = sqrtg * (d11 + half_g * h11 * dhsq);
    sF[2 * S2 + j] = sqrtg * (d21 + half_g * h12 * dhsq);
    sF[3 * S2 + j] = sqrtg * dhu2;
    sF[4 * S2 + j] = sqrtg * (d12 + half_g * h12 * dhsq);
    sF[5 * S2 + j] = sqrtg * (d22 + half_g * h22 * dhsq);
    dforce1 = rot2 * (g101 * dhu1 + g102 * dhu2) + c111 * d11 + T(2) * c112 * d12;
    dforce2 = rot2 * (g201 * dhu1 + g202 * dhu2) + T(2) * c212 * d12 + c222 * d22;
    if constexpr (TOPO) {
      dforce1 = swk::fmadd(P.force[pt], dh, dforce1);
      dforce2 = swk::fmadd(P.force[nq + pt], dh, dforce2);
    }
  }
  __syncthreads();

  const int istride = nel * (nel + 1) * S;
  const int n_items = 4 * eb * S;
  for (int it = tid; it < n_items; it += blockDim.x) {
    const int side = it / (eb * S);  // faces: 0 west, 1 east, 2 south, 3 north
    const int r = it - side * (eb * S);
    const int e = r / S;
    const int k = r - e * S;
    const int el = elem0 + e;
    if (el >= nelem) continue;
    const int p = el / per_panel;
    const int pe = el - p * per_panel;
    const int ey = pe / nel;
    const int ex = pe - ey * nel;
    bool at_edge;
    int nb_elem, hside, along;
    switch (side) {
      case 0: at_edge = ex == 0;       nb_elem = el - 1;   hside = 2; along = ey; break;
      case 1: at_edge = ex == nel - 1; nb_elem = el + 1;   hside = 3; along = ey; break;
      case 2: at_edge = ey == 0;       nb_elem = el - nel; hside = 0; along = ex; break;
      default: at_edge = ey == nel - 1; nb_elem = el + nel; hside = 1; along = ex; break;
    }
    const int nb_side = side ^ 1;
    T* sVe = smem + Sh::N_FAC + e * Sh::PER_ELEM;
    T down[3], dnb[3];
    if (at_edge) {
      swk::state_halo_point<T, S>(A.v, sExt, A.hsrc, A.hflip, A.hconv, nel, hside * 6 + p, along * S + k, dnb);
    } else {
#pragma unroll
      for (int v = 0; v < 3; ++v)
        dnb[v] = swk::face_trace<T, S>(A.v + v * nq + (long long)nb_elem * S2, sExt + nb_side * S, nb_side, k);
    }
#pragma unroll
    for (int v = 0; v < 3; ++v) down[v] = swk::face_trace<T, S>(sVe + v * S2, sExt + side * S, side, k);
    const bool own_right = side == 0 || side == 2;
    T dL[3], dR[3], dF[3], c[swk::kTangentFaceRows];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      dL[v] = own_right ? dnb[v] : down[v];
      dR[v] = own_right ? down[v] : dnb[v];
    }
    const bool is_x = side < 2;
    const int iidx = is_x ? ((ey * (nel + 1) + ex + (side == 1)) * S + k) : (((ey + (side == 3)) * nel + ex) * S + k);
    const long long cidx = is_x ? ((long long)p * nel * (nel + 1) * S + iidx)
                                : ((long long)p * (nel + 1) * nel * S + iidx);
    const T* src = A.coef + lay.face(is_x) + cidx;
#pragma unroll
    for (int row = 0; row < swk::kTangentFaceRows; ++row) c[row] = src[row * lay.nx];
    const T* itf = is_x ? A.itf_x : A.itf_y;
    swk::ausm_tangent_apply(c, dL, dR, itf[iidx], itf[istride + iidx], itf[2 * istride + iidx], is_x, dF);
    T* sFl = sVe + 9 * S2;
#pragma unroll
    for (int v = 0; v < 3; ++v) sFl[v * NF + side * S + k] = dF[v];
  }
  __syncthreads();

  if (valid) {
    const T* sFl = sF + 6 * S2;
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

template <typename T, int S>
__global__ void __launch_bounds__(swk::kThreads) sw_tangent_apply_kernel(TangentArgs<T> A, int eb) {
  tangent_apply_body<T, S, false>(A, TangentTopo<T>{}, eb);
}

template <typename T, int S>
__global__ void __launch_bounds__(swk::kThreads) sw_tangent_apply_topo_kernel(TangentArgs<T> A, TangentTopo<T> P,
                                                                                    int eb) {
  tangent_apply_body<T, S, true>(A, P, eb);
}

// Elements a block: Shape::EB, or fewer where the launch has too few
// elements to give every SM a block (a tile launch: nt = 32, s = 3 is 37
// blocks of 28 elements, 147 of 7).
int elements_per_block(int nelem, int eb_max, int sms) {
  const int eb = nelem / sms;
  return eb < 1 ? 1 : (eb < eb_max ? eb : eb_max);
}

template <typename T, int S, bool PERT, HaloFrom HALO, bool TOPO = false>
cudaError_t launch_operator(const OpArgs<T>& A, cudaStream_t stream) {
  using Sh = Shape<S>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int nelem = A.npanel * A.nel * A.nel;
  const int eb = elements_per_block(nelem, Sh::EB, sms);
  const int blocks = (nelem + eb - 1) / eb;
  auto kernel = operator_kernel<T, S, PERT, HALO, TOPO>();
  kernel<<<blocks, eb * Sh::S2, Sh::smem_bytes(sizeof(T), eb), stream>>>(A, eb);
  return cudaGetLastError();
}

template <typename T, int S>
cudaError_t launch_operator(const OpArgs<T>& A, bool pert, bool state, bool topo, cudaStream_t stream) {
  if (topo)
    return pert ? launch_operator<T, S, true, HaloFrom::kState, true>(A, stream)
                : launch_operator<T, S, false, HaloFrom::kState, true>(A, stream);
  if (state)
    return pert ? launch_operator<T, S, true, HaloFrom::kState>(A, stream)
                : launch_operator<T, S, false, HaloFrom::kState>(A, stream);
  return pert ? launch_operator<T, S, true, HaloFrom::kPlane>(A, stream)
              : launch_operator<T, S, false, HaloFrom::kPlane>(A, stream);
}

template <typename T>
cudaError_t dispatch_operator(int s, const OpArgs<T>& A, bool pert, bool state, bool topo, cudaStream_t stream) {
#define SW_CASE(S) \
  case S:          \
    return launch_operator<T, S>(A, pert, state, topo, stream);
  switch (s) {
    SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5) SW_CASE(6) SW_CASE(7) SW_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef SW_CASE
}

// What the runtime reports of the operator kernel's instantiation at its
// largest block (Shape::EB elements).
template <typename T, int S, bool PERT, HaloFrom HALO, bool TOPO = false>
cudaError_t operator_resources(int* info) {
  using Sh = Shape<S>;
  return swk::kernel_resources(operator_kernel<T, S, PERT, HALO, TOPO>(), Sh::EB * Sh::S2,
                               Sh::smem_bytes(sizeof(T), Sh::EB), info);
}

template <typename T, int S>
cudaError_t operator_resources(bool pert, bool state, bool topo, int* info) {
  if (topo)
    return pert ? operator_resources<T, S, true, HaloFrom::kState, true>(info)
                : operator_resources<T, S, false, HaloFrom::kState, true>(info);
  if (state)
    return pert ? operator_resources<T, S, true, HaloFrom::kState>(info)
                : operator_resources<T, S, false, HaloFrom::kState>(info);
  return pert ? operator_resources<T, S, true, HaloFrom::kPlane>(info)
              : operator_resources<T, S, false, HaloFrom::kPlane>(info);
}

template <typename T>
cudaError_t dispatch_resources(int s, bool pert, bool state, bool topo, int* info) {
#define SW_CASE(S) \
  case S:          \
    return operator_resources<T, S>(pert, state, topo, info);
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

// Threads a block of the apply: eb elements of s^2 nodes, rounded up to
// whole warps.
inline int apply_threads(int eb, int s2) { return (eb * s2 + 31) / 32 * 32; }

template <typename T, int S>
cudaError_t launch_tangent_prep(const TangentArgs<T>& A, const TangentTopo<T>& P, cudaStream_t stream) {
  const TangentLayout lay(A.nel, S);
  const long long total = lay.nq + 2 * lay.nx;
  const int blocks = (int)((total + swk::kThreads - 1) / swk::kThreads);
  if (P.hsurf != nullptr)
    sw_tangent_prep_topo_kernel<T, S><<<blocks, swk::kThreads, 0, stream>>>(A, P);
  else
    sw_tangent_prep_kernel<T, S><<<blocks, swk::kThreads, 0, stream>>>(A);
  return cudaGetLastError();
}

template <typename T, int S>
cudaError_t launch_tangent_apply(const TangentArgs<T>& A, const TangentTopo<T>& P, cudaStream_t stream) {
  using Sh = Shape<S>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int nelem = 6 * A.nel * A.nel;
  const int eb = elements_per_block(nelem, Sh::EB, sms);
  const int blocks = (nelem + eb - 1) / eb;
  const int threads = apply_threads(eb, Sh::S2);
  const size_t smem = Sh::smem_bytes(sizeof(T), eb);
  if (P.force != nullptr)
    sw_tangent_apply_topo_kernel<T, S><<<blocks, threads, smem, stream>>>(A, P, eb);
  else
    sw_tangent_apply_kernel<T, S><<<blocks, threads, smem, stream>>>(A, eb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_tangent(bool apply, int s, const TangentArgs<T>& A, const TangentTopo<T>& P,
                             cudaStream_t stream) {
#define SW_CASE(S) \
  case S:          \
    return apply ? launch_tangent_apply<T, S>(A, P, stream) : launch_tangent_prep<T, S>(A, P, stream);
  switch (s) {
    SW_CASE(1) SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5) SW_CASE(6) SW_CASE(7) SW_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef SW_CASE
}

template <typename T>
TangentArgs<T> tangent_args(int nel, const void* q, const void* v, const void* coef, const void* ops,
                            const void* fields, const void* gridrot, const void* itf_x, const void* itf_y,
                            const void* src, const void* flip, const void* conv, void* out) {
  TangentArgs<T> A{};
  A.q = static_cast<const T*>(q);
  A.v = static_cast<const T*>(v);
  A.coef = static_cast<const T*>(coef);
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
  return A;
}

template <typename T>
TangentTopo<T> tangent_topo(const void* const* topo) {
  return TangentTopo<T>{static_cast<const T*>(topo[0]), static_cast<const T*>(topo[1]),
                        static_cast<const T*>(topo[2]), static_cast<const T*>(topo[3])};
}

// topo: {hsurf, hsurf_x, hsurf_y, force}; all null, or the prep's first
// three and the apply's last (the kernels with topography).
int tangent_launch(bool apply, int is_f64, int s, int nel, const void* q, const void* v, const void* coef,
                   const void* ops, const void* fields, const void* gridrot, const void* itf_x, const void* itf_y,
                   const void* src, const void* flip, const void* conv, const void* const* topo, void* out,
                   void* stream) {
  if (nel < 2 || src == nullptr || flip == nullptr || conv == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return (int)dispatch_tangent<double>(apply, s, tangent_args<double>(nel, q, v, coef, ops, fields, gridrot, itf_x,
                                                                        itf_y, src, flip, conv, out),
                                         tangent_topo<double>(topo), st);
  return (int)dispatch_tangent<float>(apply, s, tangent_args<float>(nel, q, v, coef, ops, fields, gridrot, itf_x,
                                                                    itf_y, src, flip, conv, out),
                                      tangent_topo<float>(topo), st);
}

const void* const kNoTopo[4] = {nullptr, nullptr, nullptr, nullptr};

// What the runtime reports of the prep (kernel 0: blocks of kThreads, its
// factors in static shared memory, not counted) or the apply (kernel 1: at
// its largest block).
template <typename T, int S>
cudaError_t tangent_resources(int kernel, int* info) {
  using Sh = Shape<S>;
  if (kernel == 0) return swk::kernel_resources(sw_tangent_prep_kernel<T, S>, swk::kThreads, 0, info);
  if (kernel == 2) return swk::kernel_resources(sw_tangent_prep_topo_kernel<T, S>, swk::kThreads, 0, info);
  if (kernel == 3)
    return swk::kernel_resources(sw_tangent_apply_topo_kernel<T, S>, apply_threads(Sh::EB, Sh::S2),
                                 Sh::smem_bytes(sizeof(T), Sh::EB), info);
  return swk::kernel_resources(sw_tangent_apply_kernel<T, S>, apply_threads(Sh::EB, Sh::S2),
                               Sh::smem_bytes(sizeof(T), Sh::EB), info);
}

template <typename T>
cudaError_t dispatch_tangent_resources(int s, int kernel, int* info) {
#define SW_CASE(S) \
  case S:          \
    return tangent_resources<T, S>(kernel, info);
  switch (s) {
    SW_CASE(1) SW_CASE(2) SW_CASE(3) SW_CASE(4) SW_CASE(5) SW_CASE(6) SW_CASE(7) SW_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef SW_CASE
}

template <typename T>
OpArgs<T> op_args(int nel, int npanel, const void* q, const void* halo, const void* ops, const void* fields,
                  const void* gridrot, const void* itf_x, const void* itf_y, const void* x,
                  const void* q0, const void* u0, const void* itf0, const void* halo0, const void* rhs0,
                  const void* src, const void* flip, const void* conv, const void* const* topo, void* out,
                  void* traces, double a, double b, double cdt, int stage) {
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
  A.hsurf = static_cast<const T*>(topo[0]);
  A.hsurf_x = static_cast<const T*>(topo[1]);
  A.hsurf_y = static_cast<const T*>(topo[2]);
  A.topo_force = static_cast<const T*>(topo[3]);
  A.nel = nel;
  A.npanel = npanel;
  A.a = T(a);
  A.b = T(b);
  A.cdt = T(cdt);
  A.stage = stage;
  return A;
}

// halo == nullptr: the state mode (whole sphere; src, flip and conv given).
// topo: {hsurf, hsurf_x, hsurf_y, force}, all null, all given (the absolute
// state mode) or, in the perturbation form, force alone (its state mode);
// no traces with topography.
int operator_launch(int npanel, int is_f64, int s, int nel, const void* q, const void* halo, const void* ops,
                    const void* fields, const void* gridrot, const void* itf_x, const void* itf_y, const void* x,
                    const void* q0, const void* u0, const void* itf0, const void* halo0, const void* rhs0,
                    const void* src, const void* flip, const void* conv, const void* const* topo, void* out,
                    void* traces, double a, double b, double cdt, int stage, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pert = q0 != nullptr;
  const bool state = halo == nullptr;
  const bool with_topo = topo[0] != nullptr || topo[3] != nullptr;
  if (pert && (u0 == nullptr || itf0 == nullptr || halo0 == nullptr || rhs0 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (state && (npanel != 6 || src == nullptr || flip == nullptr || conv == nullptr))
    return (int)cudaErrorInvalidValue;
  if (with_topo && (!state || traces != nullptr || topo[3] == nullptr ||
                    (pert ? topo[0] != nullptr || topo[1] != nullptr || topo[2] != nullptr
                          : topo[0] == nullptr || topo[1] == nullptr || topo[2] == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      is_f64 ? dispatch_operator<double>(s, op_args<double>(nel, npanel, q, halo, ops, fields, gridrot, itf_x, itf_y,
                                                            x, q0, u0, itf0, halo0, rhs0, src, flip, conv, topo, out,
                                                            traces, a, b, cdt, stage),
                                         pert, state, with_topo, st)
             : dispatch_operator<float>(s, op_args<float>(nel, npanel, q, halo, ops, fields, gridrot, itf_x, itf_y,
                                                          x, q0, u0, itf0, halo0, rhs0, src, flip, conv, topo, out,
                                                          traces, a, b, cdt, stage),
                                        pert, state, with_topo, st);
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
                         rhs0, nullptr, nullptr, nullptr, kNoTopo, out, traces, a, b, cdt, stage, stream);
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
                         rhs0, src, flip, conv, kNoTopo, out, traces, a, b, cdt, stage, stream);
}

// The absolute state mode with bottom topography: hsurf (6*nel*nel, s^2),
// hsurf_x (6, nel, nel+1, s), hsurf_y (6, nel+1, nel, s), force (2,
// 6*nel*nel, s^2) (csrc/sw_element.cuh); the other arguments as for
// sw_operator_state_launch, without base planes and traces. All four
// planes null: sw_operator_state_launch's absolute launch.
extern "C" int sw_operator_state_topo_launch(int is_f64, int s, int nel, const void* q, const void* ops,
                                             const void* fields, const void* gridrot, const void* itf_x,
                                             const void* itf_y, const void* x, const void* src, const void* flip,
                                             const void* conv, const void* hsurf, const void* hsurf_x,
                                             const void* hsurf_y, const void* force, void* out, double a, double b,
                                             double cdt, int stage, void* stream) {
  if (nel < 2) return (int)cudaErrorInvalidValue;
  const void* topo[4] = {hsurf, hsurf_x, hsurf_y, force};
  if (hsurf == nullptr && (hsurf_x != nullptr || hsurf_y != nullptr || force != nullptr))
    return (int)cudaErrorInvalidValue;
  return operator_launch(6, is_f64, s, nel, q, nullptr, ops, fields, gridrot, itf_x, itf_y, x, nullptr, nullptr,
                         nullptr, nullptr, nullptr, src, flip, conv, topo, out, nullptr, a, b, cdt, stage, stream);
}

// The perturbation form's state mode with bottom topography: the arguments
// of sw_operator_state_launch's perturbation form (q, x, out deltas; base
// planes q0, u0, itf0, halo0, rhs0 whose traces and halo are those of h0 +
// hsurf less each interface's hsurf), without traces, and force (2,
// 6*nel*nel, s^2) the two forcing coefficients of sw_operator_state_topo_launch.
extern "C" int sw_operator_state_pert_topo_launch(int is_f64, int s, int nel, const void* q, const void* ops,
                                                  const void* fields, const void* gridrot, const void* itf_x,
                                                  const void* itf_y, const void* x, const void* q0, const void* u0,
                                                  const void* itf0, const void* halo0, const void* rhs0,
                                                  const void* src, const void* flip, const void* conv,
                                                  const void* force, void* out, double a, double b, double cdt,
                                                  int stage, void* stream) {
  if (nel < 2 || q0 == nullptr || force == nullptr) return (int)cudaErrorInvalidValue;
  const void* topo[4] = {nullptr, nullptr, nullptr, force};
  return operator_launch(6, is_f64, s, nel, q, nullptr, ops, fields, gridrot, itf_x, itf_y, x, q0, u0, itf0, halo0,
                         rhs0, src, flip, conv, topo, out, nullptr, a, b, cdt, stage, stream);
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
                         rhs0, nullptr, nullptr, nullptr, kNoTopo, out, traces, a, b, cdt, stage, stream);
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

// The linearisation of the absolute operator at q (3, 6*nel*nel, s^2),
// whole sphere, its panel-edge values taken from the state (the halo tables
// src, flip, conv of the state mode): the coefficient buffer `coef` of
// ops/sw_operator.py::sw_tangent_layout (3 node rows, 13 rows an interface
// point). ops, itf_x, itf_y as for sw_operator_state_launch.
extern "C" int sw_tangent_prep_launch(int is_f64, int s, int nel, const void* q, const void* ops, const void* itf_x,
                                      const void* itf_y, const void* src, const void* flip, const void* conv,
                                      void* coef, void* stream) {
  if (q == nullptr) return (int)cudaErrorInvalidValue;
  return tangent_launch(false, is_f64, s, nel, q, nullptr, nullptr, ops, nullptr, nullptr, itf_x, itf_y, src, flip,
                        conv, kNoTopo, coef, stream);
}

// The prep with bottom topography (hsurf, hsurf_x, hsurf_y as for
// sw_operator_state_topo_launch; all three null: sw_tangent_prep_launch).
extern "C" int sw_tangent_prep_topo_launch(int is_f64, int s, int nel, const void* q, const void* ops,
                                           const void* itf_x, const void* itf_y, const void* src, const void* flip,
                                           const void* conv, const void* hsurf, const void* hsurf_x,
                                           const void* hsurf_y, void* coef, void* stream) {
  if (q == nullptr || (hsurf == nullptr) != (hsurf_x == nullptr) || (hsurf == nullptr) != (hsurf_y == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* topo[4] = {hsurf, hsurf_x, hsurf_y, nullptr};
  return tangent_launch(false, is_f64, s, nel, q, nullptr, nullptr, ops, nullptr, nullptr, itf_x, itf_y, src, flip,
                        conv, topo, coef, stream);
}

// J(q).v from the linearisation `coef` (sw_tangent_prep_launch) in the
// direction v (3, 6*nel*nel, s^2), v's panel-edge values from v itself; out
// as v; the other arguments as for sw_operator_state_launch.
extern "C" int sw_tangent_apply_launch(int is_f64, int s, int nel, const void* v, const void* coef, const void* ops,
                                       const void* fields, const void* gridrot, const void* itf_x,
                                       const void* itf_y, const void* src, const void* flip, const void* conv,
                                       void* out, void* stream) {
  if (v == nullptr || coef == nullptr) return (int)cudaErrorInvalidValue;
  return tangent_launch(true, is_f64, s, nel, nullptr, v, coef, ops, fields, gridrot, itf_x, itf_y, src, flip, conv,
                        kNoTopo, out, stream);
}

// The apply with bottom topography: force (2, 6*nel*nel, s^2) as for
// sw_operator_state_topo_launch (null: sw_tangent_apply_launch).
extern "C" int sw_tangent_apply_topo_launch(int is_f64, int s, int nel, const void* v, const void* coef,
                                            const void* ops, const void* fields, const void* gridrot,
                                            const void* itf_x, const void* itf_y, const void* src, const void* flip,
                                            const void* conv, const void* force, void* out, void* stream) {
  if (v == nullptr || coef == nullptr) return (int)cudaErrorInvalidValue;
  const void* topo[4] = {nullptr, nullptr, nullptr, force};
  return tangent_launch(true, is_f64, s, nel, nullptr, v, coef, ops, fields, gridrot, itf_x, itf_y, src, flip, conv,
                        topo, out, stream);
}

// The same report as sw_operator_resources of the tangent prep (kernel 0)
// or apply (kernel 1) at (is_f64, s), and of their topography kernels (2, 3).
extern "C" int sw_tangent_resources(int is_f64, int s, int kernel, int* info) {
  return (int)(is_f64 ? dispatch_tangent_resources<double>(s, kernel, info)
                      : dispatch_tangent_resources<float>(s, kernel, info));
}

// What the runtime reports of the operator kernel at (is_f64, s, pert), halo
// plane: info = [registers, local (spill) bytes a thread, dynamic shared
// memory bytes a block, resident blocks an SM, threads a block], at its
// largest block.
extern "C" int sw_operator_resources(int is_f64, int s, int pert, int* info) {
  return (int)(is_f64 ? dispatch_resources<double>(s, pert != 0, false, false, info)
                      : dispatch_resources<float>(s, pert != 0, false, false, info));
}

// The same of the state mode's instantiation.
extern "C" int sw_operator_state_resources(int is_f64, int s, int pert, int* info) {
  return (int)(is_f64 ? dispatch_resources<double>(s, pert != 0, true, false, info)
                      : dispatch_resources<float>(s, pert != 0, true, false, info));
}

// The same of the state mode with bottom topography.
extern "C" int sw_operator_topo_resources(int is_f64, int s, int* info) {
  return (int)(is_f64 ? dispatch_resources<double>(s, false, true, true, info)
                      : dispatch_resources<float>(s, false, true, true, info));
}

// The same of the perturbation form's state mode with bottom topography.
extern "C" int sw_operator_pert_topo_resources(int is_f64, int s, int* info) {
  return (int)(is_f64 ? dispatch_resources<double>(s, true, true, true, info)
                      : dispatch_resources<float>(s, true, true, true, info));
}

extern "C" const char* sw_operator_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
