// Whole-run shallow-water kernel: nsteps complete TVD-RK3 (two-register SSP)
// steps in one cooperative launch.
//
// Replaces the TPU kernel wxfactory_tpu/ops/pallas_sw.py::kr_run (with
// tvdrk3_abc, _slabs_to_flat and _make_kr): every stage of every step runs
// inside one kernel, with the registers, the panel-edge traces and the halo
// exchange kept inside it, absolute form or (PERT, the base planes given) the
// perturbation form. Stage k computes y_out = a_k*x + b_k*y_in +
// cdt_k*RHS(y_in) with x the step's start state; the coefficients arrive as
// host numbers. Its plain version is ops/sw_operator.py::sw_run_plain
// (nsteps x 3 iterations of the plain stage with its traces and halo); the
// wrapper sw_run there launches this kernel.
//
// Design. Each element reads the rows of its neighbours' states that face it
// to re-extrapolate their traces, so a stage cannot update its input in
// place: the kernel keeps three state buffers (the step's start x, the stage
// input, the stage output, rotated so that the last step's result lands in
// `out`) and two trace buffers (the stage input's traces, read by the
// panel-edge faces through the halo exchange, and the output's, written by
// the edge elements). A grid-wide barrier (cooperative_groups::this_grid()
// .sync()) separates the stages; one more follows the bootstrap, in which
// the kernel extrapolates the input state's traces itself. Each stage is a
// grid-stride loop over element blocks of swk::element_block, the
// sum-factorised body of the per-stage kernel sw_operator_kernel
// (csrc/sw_operator.cu), with the halo values computed from the traces by
// swk::halo_point, the body of sw_halo_kernel: with the same coefficients
// the run gives the same bits as the chain of per-stage launches (one
// operator launch a stage, its panel-edge faces reading the neighbour
// panels' state through swk::state_halo_point). The grid is as large as
// the card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// SMs, at most one block per element block: 3 blocks of 256 threads an SM
// in float32, 2 in float64 at s=4); a launch the card cannot hold returns
// its error and no stage runs.
//
// What bounds it (H100, nel=64, s=4, 20 steps; tools/sw_operator_ablation.py):
// each stage reads the stage input (and x), writes the output and touches
// the metric, ~6-10 MB in float32 and twice that in float64; the base planes
// add ~22 MB in float32 and ~44 MB in float64, which with the state buffers
// no longer fit the 50 MB L2. A stage takes ~23 us in float32 (the face loop,
// its square roots, divides and dependent loads, ~44 % of it), ~48 us in
// float64 (where reading the metric and base planes from one element instead
// cuts a third). Two choices were measured and not taken: keeping each owned
// element's metric and base planes in shared memory across stages (at most
// 2 % in float32; in float64 the 3.2 KB an element of 1536 element blocks on
// 264 resident blocks does not fit), and emitting every face trace so the
// next stage reads one value a face instead of s (at most 5 %, the whole
// neighbour-row share, against twice the trace writes). It saves what the
// per-stage chain pays on the host: three operator and three halo launches a
// step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sw_element.cuh"

namespace cg = cooperative_groups;

namespace {

using swk::OpArgs;
using swk::Shape;

template <typename T>
struct RunArgs {
  OpArgs<T> op;          // constants, base planes and halo tables; q = the input state
  T* buf[3];             // state buffers; buf[0] is `out`
  T* tr[2];              // trace buffers
  T a[3], b[3], cdt[3];  // per-stage coefficients
  int nsteps;
};

template <typename T, int S, bool PERT>
__global__ void __launch_bounds__(swk::kThreads) sw_run_kernel(RunArgs<T> R) {
  using Sh = Shape<S>;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nel = R.op.nel;
  const int nblocks = (6 * nel * nel + Sh::EB - 1) / Sh::EB;

  swk::load_factors<T, S>(R.op.ops, smem);
  __syncthreads();
  // Bootstrap: the input state's panel-edge traces.
  const long long ntr = 3LL * 24 * nel * S;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < ntr; t += (long long)gridDim.x * blockDim.x)
    R.tr[0][t] = swk::trace_point<T, S>(R.op.q, smem, nel, t);
  grid.sync();

  // Buffers: the step's x in buf[ix] (the input itself at step 0), the first
  // stage's output in buf[iy], the second's in buf[2]; the third stage writes
  // the new x into buf[iy]. ix and iy swap every step, so buf[0] ends as the
  // result when iy starts at 0 for odd nsteps and at 1 for even.
  int ix = -1, iy = (R.nsteps % 2 == 1) ? 0 : 1;
  int itr = 0;
  for (int step = 0; step < R.nsteps; ++step) {
    const T* x = ix < 0 ? R.op.q : R.buf[ix];
    for (int k = 0; k < 3; ++k) {
      OpArgs<T> A = R.op;
      A.q = k == 0 ? x : (k == 1 ? R.buf[iy] : R.buf[2]);
      A.out = k == 1 ? R.buf[2] : R.buf[iy];
      A.x = R.a[k] != T(0) ? x : nullptr;
      A.halo = R.tr[itr];
      A.traces = R.tr[1 - itr];
      A.a = R.a[k];
      A.b = R.b[k];
      A.cdt = R.cdt[k];
      A.stage = 1;
      for (int blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
        swk::element_block<T, S, PERT, swk::HaloFrom::kTraces>(A, blk, Sh::EB, smem);
        __syncthreads();  // the next element block reuses the shared regions
      }
      grid.sync();
      itr = 1 - itr;
    }
    const int old_x = ix;
    ix = iy;
    iy = old_x < 0 ? 1 - ix : old_x;
  }
}

template <typename T, int S, bool PERT>
cudaError_t launch_run(RunArgs<T> R, cudaStream_t stream) {
  using Sh = Shape<S>;
  auto kernel = sw_run_kernel<T, S, PERT>;
  const size_t smem = Sh::smem_bytes(sizeof(T), Sh::EB);
  cudaError_t err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Sh::EB * Sh::S2, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int nblocks = (6 * R.op.nel * R.op.nel + Sh::EB - 1) / Sh::EB;
  const int grid = per_sm * sms < nblocks ? per_sm * sms : nblocks;
  void* args[] = {&R};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(Sh::EB * Sh::S2), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// What the runtime reports of the run kernel's instantiation (s = 4).
template <typename T, bool PERT>
cudaError_t run_resources(int* info) {
  using Sh = Shape<4>;
  return swk::kernel_resources(sw_run_kernel<T, 4, PERT>, Sh::EB * Sh::S2, Sh::smem_bytes(sizeof(T), Sh::EB), info);
}

template <typename T>
RunArgs<T> run_args(int nel, const void* q, const void* ops, const void* fields, const void* gridrot,
                    const void* itf_x, const void* itf_y, const void* q0, const void* u0, const void* itf0,
                    const void* halo0, const void* rhs0, const void* src, const void* flip, const void* conv,
                    void* out, void* buf1, void* buf2, void* tr0, void* tr1, const double* abc, int nsteps) {
  RunArgs<T> R{};
  OpArgs<T>& A = R.op;
  A.q = static_cast<const T*>(q);
  A.ops = static_cast<const T*>(ops);
  A.fields = static_cast<const T*>(fields);
  A.gridrot = static_cast<const T*>(gridrot);
  A.itf_x = static_cast<const T*>(itf_x);
  A.itf_y = static_cast<const T*>(itf_y);
  A.q0 = static_cast<const T*>(q0);
  A.u0 = static_cast<const T*>(u0);
  A.itf0 = static_cast<const T*>(itf0);
  A.halo0 = static_cast<const T*>(halo0);
  A.rhs0 = static_cast<const T*>(rhs0);
  A.hsrc = static_cast<const int*>(src);
  A.hflip = static_cast<const int*>(flip);
  A.hconv = static_cast<const T*>(conv);
  A.nel = nel;
  A.npanel = 6;
  R.buf[0] = static_cast<T*>(out);
  R.buf[1] = static_cast<T*>(buf1);
  R.buf[2] = static_cast<T*>(buf2);
  R.tr[0] = static_cast<T*>(tr0);
  R.tr[1] = static_cast<T*>(tr1);
  for (int k = 0; k < 3; ++k) {
    R.a[k] = T(abc[k]);
    R.b[k] = T(abc[3 + k]);
    R.cdt[k] = T(abc[6 + k]);
  }
  R.nsteps = nsteps;
  return R;
}

}  // namespace

// nsteps TVD-RK3 steps of q (3, 6*nel*nel, 16) in one cooperative launch (s = 4
// only, the shape of the TPU kernel). abc: 9 host numbers, the rows (a_k),
// (b_k), (cdt_k) of the three stages. out, buf1, buf2: state-sized, tr0, tr1:
// trace-sized scratch (3, 4, 6, nel, 4); src, flip, conv: the halo tables of
// sw_halo_launch. q0 != NULL: the perturbation form (q and out carry deltas).
// Returns the cudaError_t (0 on success): a grid the card cannot hold at once,
// or a refused cooperative launch, returns its error and runs nothing.
extern "C" int sw_run_launch(int is_f64, int s, int nel, const void* q, const void* ops, const void* fields,
                             const void* gridrot, const void* itf_x, const void* itf_y, const void* q0,
                             const void* u0, const void* itf0, const void* halo0, const void* rhs0,
                             const void* src, const void* flip, const void* conv, void* out, void* buf1,
                             void* buf2, void* tr0, void* tr1, const double* abc, int nsteps, void* stream) {
  if (s != 4 || nel < 2 || nsteps < 1) return (int)cudaErrorInvalidValue;
  const bool pert = q0 != nullptr;
  if (pert && (u0 == nullptr || itf0 == nullptr || halo0 == nullptr || rhs0 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_f64) {
    RunArgs<double> R = run_args<double>(nel, q, ops, fields, gridrot, itf_x, itf_y, q0, u0, itf0, halo0, rhs0, src,
                                         flip, conv, out, buf1, buf2, tr0, tr1, abc, nsteps);
    err = pert ? launch_run<double, 4, true>(R, st) : launch_run<double, 4, false>(R, st);
  } else {
    RunArgs<float> R = run_args<float>(nel, q, ops, fields, gridrot, itf_x, itf_y, q0, u0, itf0, halo0, rhs0, src,
                                       flip, conv, out, buf1, buf2, tr0, tr1, abc, nsteps);
    err = pert ? launch_run<float, 4, true>(R, st) : launch_run<float, 4, false>(R, st);
  }
  return (int)err;
}

// What the runtime reports of the run kernel (s = 4) at (is_f64, pert):
// info as for sw_operator_resources.
extern "C" int sw_run_resources(int is_f64, int pert, int* info) {
  if (is_f64) return (int)(pert ? run_resources<double, true>(info) : run_resources<double, false>(info));
  return (int)(pert ? run_resources<float, true>(info) : run_resources<float, false>(info));
}

extern "C" const char* sw_run_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
