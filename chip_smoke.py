#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wxfactory_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
CUDA kernels from csrc/ (one nvcc per source, sm_90a, all started together)
and drives the port's main paths, shallow water, 3D Euler and the 2D
Cartesian Euler model:

0. environment: card name and power limit, torch/CUDA/nvcc/sympy versions,
   kernel build time and the compiler's register/spill report;
1. the SW operator kernel against its plain torch version on the card, at
   (nel, s) = (10,3), (64,3), (4,2), (4,8), (64,7), float64 and float32, in
   RHS mode, stage mode with and without x, and with emitted traces
   (tolerances in wxfactory_tpu_torch/kernels/check.py); each call also
   holds mass (the weighted integral of its h change against the plain
   version's);
2. the same case-6 run (nel=10, s=3, TVD-RK3, dt=30 s, 20 steps, f64) on
   the GPU and on the CPU (plain version): final states agree to 1e-10 of
   each variable's max;
3. the SW main path at full width: ``python -m wxfactory_tpu_torch`` on
   Williamson case 6, nel=64, s=3, f64, TVD-RK3, dt=10 s, 360 steps, with
   exactly one kernel launch per RK stage (the operator's state mode, its
   panel-edge faces reading the neighbour panels' state) and no edge-trace
   or halo launch, a finite state, mass drift below 1e-10 and a checkpoint
   that reads back;
4. time per RHS call of the SW kernel's state mode (the main path's call)
   and of the plain version at nel=64, s=3 (CUDA events, median), f64 and
   f32, with a state-mode stage and the halo-plane RHS beside them;
5. the 3D Euler operator kernel against its plain version on the card, at
   (nel_h, nel_v, s) = (3,2,2), (12,3,2), (4,2,3), (20,20,3), (4,4,4),
   (3,2,5), (2,2,6), (7,3,3) on DCMIP 31 and (4,2,3) on the rotating planet
   of case 77, float64 and float32, in RHS mode, stage mode with and without
   x, with emitted traces, and (float32) with the well-balanced offset; each
   call also holds mass (the weighted integral of its rho change against
   the plain version's);
6. the same dcmip31 run (3x2x2, s=2, TVD-RK3, dt=2 s, 10 steps, f64) on the
   GPU and on the CPU: final states agree to 1e-10 of each variable's max;
7. the 3D main path: ``python -m wxfactory_tpu_torch`` on dcmip31 at
   nel_h = nel_v = 20, s=3 (1,296,000 points), f64, TVD-RK3, dt=0.1 s, 100
   steps (10 simulated seconds), then the canonical 12x12x3, s=2, dt=0.5 s,
   75 steps; each with exactly one kernel launch per RK stage, a finite
   state, mass drift below 1e-11 and checkpoints that read back;
8. time per call at 20x20x3, s=3 of the 3D kernel (RHS; stage + x +
   traces: the card's time, 20 calls queued behind a sleep kernel, in
   turns), its plain version and the halo glue (CUDA events, median), f64
   and f32, beside the call's memory/compute bound, with the registers,
   spills, shared memory a block and resident blocks an SM of its two
   kernels (the interface and volume passes; absolute and perturbation
   mode) and their launch geometry;
9. the Jacobian action J(q).v from the tangent prep kernel (once per
   linearisation point: the coefficient buffer) and the linear apply
   kernel against its plain version (torch.func.jvp of the plain operator)
   on the card at every shape of phase 5, f64 within 1e-12 of the plain
   J.v's max per variable, f32 within 5e-5 of the f64 plain J.v's or twice
   the f32 plain J.v's distance; the apply's linearity (apply(a v + b w)
   against a apply(v) + b apply(w)) within the same tolerance; each kernel
   against its own plain version (the f64 prep's buffer within 1e-12 of
   each row's max, the apply on that buffer within the tangent tolerance)
   (rows in build/chip_smoke/phase9.json);
10. the same dcmip31 EPI2+KIOPS run (4x2x2, s=2, dt=30 s, 2 steps, f64) on
    the GPU and on the CPU: identical Krylov statistics at every step, final
    states within 1e-10 of each variable's max;
11. the EPI2 main path: ``Simulation(ini).run()`` on dcmip31 with
    epi2, kiops, tolerance 1e-7, dt=30 s, at the canonical 12x12x3, s=2 for
    5 steps, then at 20x20x3, s=3 for 3 steps; each with one RHS-kernel
    launch a step, one tangent apply launch per Jacobian action the
    integrator asked for, one tangent prep launch a step (the
    linearisation point), no plain call, a finite state, mass drift
    below the KIOPS tolerance 1e-7 at every step (the first step's update
    cancels ~12 orders of magnitude at the balanced initial state and moves
    mass by a few 1e-8, as in the JAX package; tools/epi2_mass_drift.py)
    and checkpoints (one a step) that read back; it reports steps/s, setup
    time, the Krylov statistics and (torch.profiler, on the same
    Simulation from its initial state) the tangent kernels' share of device
    time;
12. time per call at 20x20x3, s=3, in turns, f64 and f32, of the tangent
    prep and apply kernels (the card's time, calls queued behind a sleep
    kernel) and (CUDA events, median) their plain versions, the
    plain tangent (torch.func.jvp), the tangent glue and the RHS kernel,
    beside the function's memory/compute bound, the apply's own bytes floor
    (kernels/check.py::euler3d_tangent_apply_work), the prep's bound, and
    the kernels' registers, spills, shared memory and resident blocks an SM
    as the runtime reports them;
13. the kernel's perturbation mode (RHS: rhs0 + delta; tangent: J(q0 +
    dq).v from the perturbation prep and the apply) against its plain
    version on the card at every shape of phase 5, f64 within 1e-12, f32
    within 5e-5 of the f64 plain output or twice the f32 plain output's
    distance, with the linearity and kernel-by-kernel checks of phase 9
    and the mass check of phase 5 on the RHS (rows in
    build/chip_smoke/phase13.json);
14. the same dcmip31 EPI2 runs with kiops_jit (dt=30 s, 2 steps) on the GPU
    and the CPU: float64 at 4x2x2, s=2 with identical Krylov statistics and
    states within 1e-10, mixed precision (the float32 perturbation
    companion) at 4x2x4, s=4 within 2e-5 (and its distance at 4x2x2
    reported);
15. the mixed-precision EPI2 main path: ``python -m wxfactory_tpu_torch``
    with epi2, kiops_jit, mixed_precision_krylov = 1, device_step_chunk = 5,
    at the canonical 12x12x3, s=2 (10 steps) and at 20x20x20, s=3 (5 steps),
    then with mixed_precision_krylov = 0 (the float64 kiops_jit step) at
    12x12x3, s=2 and 20x20x10, s=3 (5 and 5 steps; the profile on a second build at the canonical shapes and
    the mixed main one);
    each with one tangent apply launch (on the perturbation prep's buffer
    when mixed) per Jacobian action, one prep launch a step, one RHS launch
    a step (and, mixed, the float64 base RHS at setup), no plain call, host
    syncs a step at most the Krylov
    controls + 2, a finite state, mass drift below the KIOPS tolerance at
    every checkpoint (every chunk's end) and checkpoints that read back; it
    reports steps/s, setup time, the Krylov statistics, the syncs and (on a
    second build) the device's busy share and its split by kernel class;
16. phase 12's timing for the perturbation form (the perturbation prep and
    the apply on its buffer, their plain versions, the plain tangent, the
    glue and the perturbation RHS kernel beside their bounds), and one
    Arnoldi iteration of each kiops_jit variant (a 64-iteration cycle);
17. the SW operator's perturbation mode (RHS rhs0 + delta, stages of deltas,
    emitted delta traces), the halo kernel and the edge-trace kernel against
    their plain versions at the shapes of phase 1 and (8,4), (32,4), (64,4),
    f64 and f32 (rows in build/chip_smoke/phase17.json), and the whole-run
    kernel at (32,4) and (64,4), 1-3 steps, absolute and perturbation form,
    against the plain loop and, asked bit for bit, the chained per-stage
    kernels; every operator call and run also holds mass (phase 1's check);
18. GPU against CPU: 10 float64 TVD-RK3 steps of the SW perturbation form
    at nel=10, s=3, and packed_run at (32,4) for 2 steps (absolute and
    perturbation), within 1e-10 of each variable's max;
19. the SW production operating point as bench.py:449-495 drives it: case
    6, float32, perturbation form around the initial state, at (nel, s, dt,
    steps) = (10,3,30,200) and (64,3,10,100) chained, and (64,4,30,100) in
    one packed_run launch beside the same steps chained; each with its
    grid points/s, launch counts (3 state-mode operator launches a step, no
    halo or edge-trace launch and no plain call; one launch a packed_run;
    the edge-trace, halo and operator launches that build the perturbation
    base at setup counted apart),
    device busy share (from a torch.profiler trace) and device span share
    (queued behind a sleep kernel, the card's launch gaps included), a
    finite state, mass drift below float32's machine epsilon, packed_run
    bit for bit equal to the chained kernels, and the bench's accuracy
    gate (the f32 perturbation RHS within 5e-3 of the tendency scale of the
    f64 truth at a 4-step drift state, the f32 absolute error beside it);
    then a float32, s=4, nel=32 case-6 INI through ``python -m
    wxfactory_tpu_torch`` for 50 steps with its launches counted;
20. time per call (the card's time, calls queued behind a sleep kernel
    between two CUDA events; and CUDA events around single calls, median),
    f64 and f32, beside the bounds: the operator (absolute RHS) and its
    perturbation mode (RHS; stage + x + traces) and their plain versions at
    (64,3), (64,4) and (64,7), the state mode (halo=None; absolute RHS and
    perturbation stage + x) against its plain version and, in turns on the
    card, against the three launches it replaces (edge-trace, halo and
    operator kernels), the halo kernel against halo_from_traces, the
    edge-trace kernel against edge_traces, and a packed_run step against a
    chained step at (64,4); the state mode held bit for bit against those
    three launches (kernels/check.py::compare_sw_state_halo: absolute and
    perturbation, RHS and stages, with mass) at (64,3), (64,4), (64,7) and
    (4,2), (3,5), (2,6), (4,8); with the registers, spills, shared memory a
    block and resident blocks an SM of every SW operator instantiation
    (s = 2..8, f64/f32, absolute/perturbation, halo plane and state mode)
    and of the run kernel, as the runtime reports them
    (sw_operator_resources, sw_operator_state_resources, sw_run_resources);
21. the 3D kernel's perturbation stage mode (a*dx + b*dq + cdt*(rhs0 +
    delta), a = 0 and a != 0, with the output's delta traces) against its
    plain version at every shape of phase 5, f64 within 1e-12 of scale, f32
    within 5e-5 of the f64 plain output or twice the f32 plain output's
    distance, the emitted traces against edge_traces_delta of the
    kernel's own output, and the mass check of phase 5 (rows in
    build/chip_smoke/phase21.json);
22. the 3D production explicit point as bench.py:623-685 drives it:
    dcmip31, float32 perturbation form around the initial state through
    Tvdrk3, at (nel_h, nel_v, s, dt, steps) = (12,3,2,0.5,75) and
    (20,20,3,0.1,100), with exactly three perturbation stage launches a
    step, no other operator launch and no plain call, the bench's accuracy
    gate (the f32 perturbation RHS within 5e-3 of the f64 truth's tendency
    scale at a 4-step drift state), a finite state and mass drift below
    float32's epsilon; grid points/s, the trace's busy share and the
    sleep-queued device span; the f32 form with the well-balanced offset
    and the f64 absolute form beside it (same launch and state checks, f64
    mass drift below 1e-11);
23. dcmip31 Ros2 (tolerance 1e-7, gmres_restart 20) through
    Simulation(ini).run() at the canonical 12x12x3, s=2, dt=30 s (5 steps)
    and at 20x20x10, s=3, dt=2 s (3 steps; FGMRES without a
    preconditioner stalls there at dt=30 s): the host fgmres,
    fgmres_jit float64 and
    fgmres_jit with mixed_precision_krylov = 1, both with
    device_step_chunk = 5 and under forbid_uncounted_syncs; tangent apply
    launches (f64 and perturbation) equal to the Jacobian actions, one prep
    launch a step for each linearisation (two when mixed: the f64 system's
    and the companion's), one RHS launch a step, no plain call, host syncs,
    state and mass at the
    checkpoints; the mixed run against the f64 run after two steps within
    5e-5 of each variable's max and 2e-3 on rho*w;
24. time at 20x20x20, s=3 of the perturbation stage kernel against its
    plain version and its bound, f64 and f32, and of an FGMRES inner
    iteration split into basis products, tangent kernel and the rest,
    float64 and mixed;
25. the tile kernels (one tile of the tile-parallel step, the ports of
    km_tile and km3_tile) against their plain versions, absolute and
    perturbation form, RHS and stages with a = 0 and a != 0, float64 and
    float32: SW at (nt, s) = (4,3), (8,4), (32,3) on a tile of a 2x2 mesh
    and (64,4) on a whole panel; 3D at (nt, nk, s) = (2,3,2), (5,8,3),
    (10,20,3), (7,3,3) and the rotating planet at (2,3,3) on 2x2 meshes,
    (20,20,3) on a whole panel (tolerances and the mass check in
    kernels/check.py, _compare_tile);
26. the tile-parallel TVD-RK3 step with every tile in one process, 40
    steps: SW case 6 at nel=64, s=3, dt=10 s (float64 and float32
    absolute, float32 perturbation) and dcmip31 at 20x20x20, s=3, dt=0.1
    s (float64 absolute, float32 perturbation), each at N=1 and N=2;
    exactly 3 * 6N^2 tile launches a step, no other operator, halo or
    edge launch and no plain call; against the port's global chain on the
    card (float64 within 1e-12 of each variable's max; float32 within
    5e-3 of each variable's change over the run, the bench's gate), a
    finite state and mass drift within the global chain's gates (float32
    absolute, which has none: twice the global chain's own drift); steps/s,
    grid points/s, device busy share and launches a step;
27. the CLI with 6 ranks sharing the card (``python -m wxfactory_tpu_torch
    cfg.ini --coordinator ... --num-processes 6 --process-id r``, gloo,
    halos staged through host memory, distribute = shard_map): case 6 at
    nel=16, s=3 and dcmip31 at 12x12x3, s=2, float64; rank 0's last
    checkpoint within 1e-12 of a single-process run's, and the wall time
    (host-bound by the staging);
28. the card's time a call of the tile kernels at the tiles of phase 26
    (SW nt = 64 and 32, s=3; 3D nt = 20 and 10, nk = 20, s=3), the stage
    the step launches (x, traces), float64 absolute and float32 (absolute
    and perturbation for SW, perturbation for 3D), beside the bound of
    kernels/check.py's *_tile_work and the plain version's time; the SW rows
    with the operator kernel's registers, spills, shared memory a block and
    blocks an SM;
29. the SW tangent kernel (J(q).v of the absolute operator, one launch, its
    halos from the state) against its plain version (torch.func.jvp of the
    plain operator) at (nel, s) = (10,3), (30,3), (64,3), (64,4), (64,7),
    (4,2), (3,5), (2,6), (4,8), at a case-6 state and at rest (every split
    Mach number exactly 0, the tie), f64 within 1e-12 of scale, f32 within
    twice the f32 plain J.v's distance from the f64 one (or 1e-5); its
    linearity in v, the mass of (J.v)_h against the plain version's, and
    (f64, case 6) a centred difference of the operator kernel to second
    order; the card's time a call at (10,3), (30,3), (64,3) beside the
    bound, the plain version's and the state-mode RHS's; registers, spills,
    shared memory and blocks an SM at s = 2..8 (rows in
    build/chip_smoke/phase29.json);
30. the SW exponential and Rosenbrock paths through Simulation(ini).run()
    (the CLI's call), case 6, s=3, f64, tolerance 1e-7: (a) canonical run 1,
    nel=10, dt=1800 s, EPI3 + pmex, the 10-substep Epi2 bootstrap and 4
    EPI3 steps; (b) the same with kiops_jit and mixed_precision_krylov = 1
    (the float32 perturbation-form companion, its Arnoldi J.v the absolute
    float32 operator's); (c) (b) at nel=30, dt=900 s, 4 steps; (d) Ros2 +
    fgmres_jit, nel=10, dt=1800 s, 2 steps; each with one state-mode
    operator launch an RHS call, one tangent launch a Jacobian action, no
    plain call, a finite state with 7,500 < h < 11,000, blockstats mass
    drift below 1e-10 (mixed: the Krylov tolerance) at every step; steps/s,
    Krylov iterations and host syncs a step; and (a) again on the CPU:
    identical Krylov statistics, final states within 1e-9 of scale;
31. the kernels with bottom topography (Williamson case 5) against their
    plain versions at the shapes of phase 1, f64 and f32: the state mode's
    RHS, stage and stage with x (with mass; its null topography planes bit
    for bit the kernel without topography, all-zero planes bit for bit the
    null ones) and the tangent prep and apply (phase 29's checks on case 5
    and on case 5 at rest); the tangent pair at s = 1 (the fv-mg levels) at
    (nel, 1) = (4,1), (10,1), (20,1), (64,1), (128,1); the card's time a
    call with and without topography at (10,3) and (64,3), and of the s = 1
    pair at (20,1) and (128,1), beside the bounds (rows in
    build/chip_smoke/phase31_*.json);
32. the SW cases through Simulation(ini).run(), float64, tolerance 1e-7:
    case 5 at nel=10, s=3, EPI3 + pmex, dt=1800 s (5 steps) and at nel=64,
    s=3, TVD-RK3, dt=10 s (30 steps); Galewsky (case 8) at nel=30, s=3,
    dt=900 s, EPI3 + kiops_jit mixed (4 steps) and at (64,7), TVD-RK3, dt=10
    s (10 steps; its setup includes the balance quadrature); cases 0, 2, 9
    and 10 for 3 TVD-RK3 steps at nel=10, dt=300 s; each with one
    state-mode launch an RHS call or stage (with topography for 5 and 10),
    one tangent apply a Jacobian action and one prep a linearisation point
    (with topography for case 5), no plain call, a finite checkpoint and
    blockstats mass drift below 1e-10 (the mixed companion: 1e-7); case 1
    stops at step 1 at the NaN guard (h = 0 off the bell), as the JAX
    package's does; the case-5 EPI3 run against the same run on the CPU:
    identical Krylov statistics, within 1e-9 of scale;
33. the preconditioned solves on the card: the case-5 rational system
    (nel=10, s=3, dt=3600 s) by FGMRES(100) alone, with 2-level p-mg
    (kiops smoother, pseudo_cfl 720) and with 3-level fv-mg (its FV levels
    on the s = 1 tangent pair), gated as the JAX package's
    tests/test_framework.py:316-317 (p-mg: 4x fewer iterations, residual
    within 1.05 of the plain one; fv-mg: no more iterations than plain);
    lu and ilu at nel=4, s=2 (fewer iterations than plain); Ros2 + p-mg
    through Simulation on case 5 (nel=10, dt=1800 s, 2 steps; kiops
    smoother) and on dcmip31 at 20x20x3, s=3, dt=30 s (1 step; erk3
    smoother, pseudo_cfl 5), each beside the same run without a
    preconditioner (the host FGMRES with p-mg, the device FGMRES without,
    as linear_solver = auto takes them; on dcmip31, where it stagnates,
    with a budget of 2,000 FGMRES iterations): FGMRES iterations a step, steps/s,
    the levels' prep and apply launches, no plain call;
34. DCMIP 20, 21 and 22 over terrain: the terrain instantiations of the 3D
    kernels (every panel's metric; the Rayleigh sponge of 21/22 in the
    volume pass and the apply) against their plain versions at (nel_h,
    nel_v, s) = (4,3,3), (3,2,2), (20,20,3), float64 and float32: DCMIP 21
    absolute with its sponge (RHS, stages, traces, the well-balanced offset
    in f32; the tangent prep and apply against the plain tangent), DCMIP 20
    absolute and in the perturbation form (RHS, tangent, stage + delta
    traces); f64 within 1e-12 of scale, f32 by the rules of phases 5, 9,
    13 and 21 (the f32 J.v against the f64 J.v that takes the side the
    f32 prep took at each near-tie of the Rusanov speeds, at every
    element: kernels/check.py::_side_truths); every operator call holding
    mass; the sponge acting on the momenta only (rho and rho*theta of the
    RHS and J.v bit for bit those without it, the momentum rows'
    difference the plain sponge term); DCMIP 31's constants copied to
    every panel through the terrain kernels bit for bit the kernels
    without terrain, in every mode; the
    card's time a call at (20,20,3) of each terrain kernel in turns with
    the same call without terrain (DCMIP 31), the plain versions' and the
    bounds (six panels' metric and the sponge's planes counted) and the
    terrain kernels' resources; DCMIP 20 and 21 at 4x3x3 on the card and
    the CPU within 1e-10 (and DCMIP 20's max |w|, the terrain error, of
    each); and the paths through Simulation(ini).run() (the CLI's call,
    INIs under build/chip_smoke/): (a) DCMIP 21 TVD-RK3 f64 at 20x20x20, s
    = 3, ztop = 30 km, dt = 0.1 s; (b) DCMIP 21 EPI2 + host KIOPS at
    20x10x3 (10 levels keep the script within its time limit), dt = 2 s;
    (c) DCMIP 20 EPI2 + kiops_jit mixed (the float32 perturbation
    companion on the per-panel metric), 20x10x3, ztop = 12 km, dt = 30 s;
    (d) DCMIP 22 TVD-RK3 at 20x10x3, dt = 0.1 s; (e) DCMIP 20's tile step
    at N = 1 (every tile in this process), float64 bit for bit the global
    chain on the terrain kernels and float32 perturbation within the
    bench's gate of its global chain (the terrain perturbation stage
    kernel); each with only terrain launches (or tile launches) and no
    plain call, a finite state, mass drift below 1e-11 (f32: its epsilon),
    max |w| and steps/s;
35. Williamson 5 and 10's float32 perturbation form with topography and
    the output layer: (a) the perturbation form's state mode with case-5
    topography (its own kernel, sw_operator_pert_topo_kernel) against its
    plain version at (10,3), (64,3), (4,2), (64,7), f64 within 1e-12 and
    f32 by phase 17's rule (the RHS on its term scale), RHS, stage and
    stage + x, each call holding mass; its card time at (64,3) (RHS and
    stage + x, f32 and f64) in turns with the perturbation kernel without
    topography, the plain version's, the bound and both kernels'
    resources; (b) through Simulation(ini).run(): case 5 EPI3 + kiops_jit
    mixed at nel = 10 (dt = 1800 s, 5 steps) and nel = 30 (dt = 900 s, 4
    steps), case 10 at nel = 10, case 5 Ros2 + fgmres_jit mixed (2 steps),
    each on topography launches only (the absolute state mode with
    topography, the float32 tangent pair with topography; the companion's
    float64 base RHS on the absolute kernel at setup) and no plain call,
    and case 5 at (4,3) on the card against the CPU within 2e-5; (c) the
    float32 perturbation TVD-RK3 chain of case 5 at (64,3), 30 steps, one
    launch of the new kernel a stage, within bench.py's 5e-3 gate; (d) the
    CLI with every output knob (NetCDF fields, solver statistics, RHS
    timing samples, the runtime file) on case 5 EPI3 at nel = 10, its
    steps/s beside the same run without output, and dcmip31 TVD-RK3 at
    12x12x3, s = 2 with field output; every file read back with scipy;
36. the integrators and solvers of ROADMAP item 12 through
    Simulation(ini).run(), float64, tolerance 1e-7, every integrator step
    inside forbid_uncounted_syncs (each host wait a counted read): (a) case
    6 at nel = 10, s = 3, dt = 1800 s, 2 steps: EPI3 with every exponential
    solver of the schema the port gained (pmex_1s, pmex_ne1s, the cwy/icwy
    low-synchronization variants, dcgs2, exode), SRERK3 + kiops and SRERK6
    + pmex; (b) SRERK3 + kiops and EPI3 + icwy_1s at nel = 30, dt = 900 s;
    (c) at nel = 10, dt = 1800 s: backward Euler, Crank-Nicolson, BDF2 (2
    steps), SDIRK, RosExp2 and Ros2 + gcrot; (d) dcmip31 at 12x12x3, s = 2,
    dt = 30 s, 2 steps: SRERK3 + pmex, EPI2 + icwy_1s, Crank-Nicolson and
    EPI2 + icwy_1s with the exponential modal filter; each with no plain
    call, one tangent apply launch a Jacobian action and one prep a
    linearisation, only state-mode operator launches (shallow water), a
    finite state, mass drift below 1e-10 (3D: the Krylov tolerance),
    steps/s, host syncs a step and the iterations a step; the nel = 10
    paths again on the CPU (the plain operator, the tangent kernels' plain
    pair): the same iterations a step, within 1e-9 of scale;
37. DCMIP 11 and 12 (tracer advection under prescribed winds): (a) the
    advection kernel (csrc/euler3d_advection.cu) against its plain version
    at (nel_h, nel_v, s) = (3,2,2), (4,3,3), (2,2,4), (2,1,5), (2,2,6),
    (7,3,3), 1 and 4 tracers, f64 and f32, and at the main path's width on
    the run's own state: RHS (rows 0-4 exactly 0), stage, stage + x and
    stage + x + traces, f64 within 1e-12 of each row's flux-divergence
    scale, f32 within 1e-5 of it or twice the plain f32 output's distance
    from the f64 one, each tracer's mass against the plain version's and
    the RHS's own mass integral zero to round-off; (b) DCMIP 11 through
    Simulation(ini).run() at 30x30x20, s = 3 (DCMIP 2012 test 1-1's ~1
    degree grid, 60 levels), ztop = 12 km, TVD-RK3, dt = 18.75 s (the
    explicit limit the JAX package's wind overwrite sets: ADVECTION_DT), 10
    steps; (c) DCMIP 12 with TVD-RK3 and Euler1 at 20x20x10, s = 3, dt =
    0.5859375 s, 10 steps; each with one advection launch a stage, no
    plain call, no five-variable 3D launch, every integrator step and wind
    overwrite inside forbid_uncounted_syncs, each tracer's mass drift
    below 1e-12, rho and rho*theta within 32 ulps of their initial values,
    the momenta rho * the numpy winds at t + dt after every step within
    1e-13, steps/s and host syncs a step; (d) both cases at 4x3x3, s = 3,
    10 TVD-RK3 steps on the card and on the CPU (the plain version) within
    1e-12 of scale; the card's time a call at 30x30x20 of the kernel (RHS;
    stage + x + traces) and its plain version, f64 and f32, beside the
    bound, with the kernel's registers, spills, shared memory and blocks an
    SM;
38. the 2D Cartesian Euler model (csrc/euler_cartesian.cu: the DFR operator,
    its tangent over a dual number, the FV operator, its tangent): (1) each
    kernel against its plain version at (nel_x, nel_z, s) = (4,3,2),
    (3,2,3), (4,3,4), (2,2,5), (2,1,6), (10,15,4) (cases 2 and 4) and FV
    grids (9,7), (40,60), (20,30) with every flux, f64 and f32: RHS (the DFR
    kernel also stage and stage + x), the tangent at a perturbed state and
    at rest (every AUSM interface and FV speed at its tie), f64 within 1e-13
    of each row's term scale (tangents 1e-12 of their max), f32 within 1e-5
    or twice the plain f32 distance from the f64 truth, every RHS's rho and
    rho*theta mass zero to 1e-14; the same at the main width on path (a)'s
    own state; each kernel on the card against its plain version on the CPU
    at 4 x 3, s = 4; (2) through Simulation(ini).run(), every step inside
    forbid_uncounted_syncs: (a) the cold density current (case 4, Straka et
    al. 1993's symmetric half, 25.6 x 6.4 km) at 256 x 64, s = 4 (262,144
    points), TVD-RK3, f64, dt = 0.02 s, 20 steps: three DFR launches a step
    and no other; (b) the same with EPI2 + KIOPS, dt = 1 s, 3 steps: one
    tangent launch a Jacobian action; (c) the Gaussian bubble (case 2) at 10
    x 15, s = 4, Ros2 + FGMRES, dt = 1 s, 2 steps, without a preconditioner,
    with p-mg (3 levels) and with fv-mg (3 levels: the FV tangent on its
    coarse levels), every level A.v one tangent launch; each with no plain
    call and no launch of the FV RHS kernel (no path calls the FV RHS), a
    finite state, the rho and rho*theta integrals conserved (1e-12; the
    Krylov paths 1e-9), steps/s, host syncs a step and the Krylov counts;
    (d) case 2 at 5 x 7, s = 4 on the card and on the CPU: TVD-RK3 10 steps
    within 1e-12 of scale, EPI2 2 steps within 1e-10 with the same Krylov
    counts; the card's time a call of each kernel at the main paths' widths
    (the FV kernels at fv-mg's first FV level, 40 x 60 cells) beside its
    plain version and bound, f64 and f32, and the kernels' resources. The FV
    RHS kernel, which no path launches, is held and timed but left out of
    the kernels line;
39. the Jacobian action of the DCMIP 11/12 advection
    (csrc/euler3d_advection_tangent.cu: a prep once a linearisation point,
    a linear apply once a J.v): (a) prep + apply against the plain pair at
    phase 37's shapes and at the main width on path (b)'s state, 1 and 4
    tracers, f64 and f32, in a random direction with every row set and on a
    state with zero normal speed on both sides of some interfaces (f64
    within 1e-12 of each row's scale, f32 within 1e-5 or twice the plain
    f32 pair's distance from the f64 one), each kernel against its plain
    version, J.(0, dT) against the advection RHS kernel, each tracer's mass;
    (b) DCMIP 11 at 30x30x20, s = 3 through Simulation(ini).run(), EPI2 +
    KIOPS, dt = 18.75 s, 3 steps: only the advection RHS kernel and the
    pair launch (one apply a J.v, one prep a linearisation), no plain call,
    a finite state, the momenta rho * the winds, each tracer's mass drift
    below 1e-12; steps/s, Krylov iterations and host syncs a step and the
    device busy share; (c) the same with kiops_jit on (b)'s Simulation; (d)
    DCMIP 12 at 20x20x10 with Ros2 + FGMRES and Crank-Nicolson, 2 steps,
    and Ros2 + lu at 3x3x2, s = 2 (one FGMRES iteration a step); (e) EPI2
    on 11 and Ros2 and Crank-Nicolson on 12 at 4x3x3 on the card and on the
    CPU, the same iteration counts, within 1e-12 (EPI2) and 1e-10; (f) the
    card's time a call of the prep and the apply at 30x30x20, 4 tracers,
    f64 and f32, beside the plain versions, the function's bound, each
    kernel's own floor and its resources.

Each phase prints one JSON line; then the kernels line, the card's
``nvidia-smi`` name and power limit, and last the result line. Any failure
raises and exits non-zero. Without a CUDA device, or outside a checkout, it
exits non-zero without a result.
"""

import contextlib
import glob
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = [(10, 3), (64, 3), (4, 2), (4, 8), (64, 7)]
SW_PERT_SHAPES = SHAPES + [(8, 4), (32, 4), (64, 4)]
KERNEL_SOURCES = ["sw_operator", "euler3d_operator", "sw_run", "euler3d_terrain", "euler3d_advection",
                  "euler_cartesian", "euler3d_advection_tangent"]
# (nel_h, nel_v, s, case); at (7, 3, 3) a panel's 147 elements leave the
# operator's volume pass (9 elements a block at s=3) a partial last block.
E3_SHAPES = [(3, 2, 2, 31), (12, 3, 2, 31), (4, 2, 3, 31), (20, 20, 3, 31), (4, 4, 4, 31), (3, 2, 5, 31),
             (2, 2, 6, 31), (4, 2, 3, 77), (7, 3, 3, 31)]
E3_MAIN = (20, 20, 3)
# The full-width float64 Krylov paths of phases 15 and 23 at half
# E3_MAIN's depth (10 levels), toward half the script's time limit: most of
# such a run's time is the setup's 3D metric. The mixed EPI2 main path of
# phase 15 runs at E3_MAIN.
E3_KRYLOV_MAIN = (20, 10, 3)
# Tile steps of phase 26: (nel, s, dt) of case 6 and (nel_h, nel_v, s, dt) of dcmip31.
SW_TILE_MAIN = (64, 3, 10.0)
E3_TILE_MAIN = E3_MAIN + (0.1,)
TILE_STEPS = 40
WORK = ROOT / "build" / "chip_smoke"
# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and FLOP/s
# outside the tensor cores by type.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}

CASE6_INI = """
[General]
equations = shallow_water
[System]
precision = float64
[Test_case]
case_number = 6
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = tvdrk3
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = {nel}
[Grid]
grid_type = cubed_sphere
[Output_options]
save_state_freq = {save}
stat_freq = {save}
output_dir = {out}
"""

DCMIP31_INI = """
[General]
equations = euler
[System]
precision = float64
[Test_case]
case_number = 31
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = kiops
tolerance = 1e-7
verbose_solver = {verbose}
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = {nel_h}
num_elements_vertical = {nel_v}
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Output_options]
save_state_freq = {save}
output_dir = {out}
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def emit_comparison(phase: int, rows, shape_keys, tag: str = "") -> None:
    """One line per (shape, dtype) with the worst scaled error over the
    modes; every row goes to build/chip_smoke/phase<N><tag>.json."""
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / f"phase{phase}{tag}.json").write_text(json.dumps(rows, indent=1))
    summary = {}
    for r in rows:
        key = tuple(r[k] for k in shape_keys) + (r["dtype"],)
        worst = summary.setdefault(key, {"err": 0.0, "traces_err": 0.0, "tol": r["tol"], "ok": True,
                                         "modes": 0})
        worst["err"] = max(worst["err"], r["err"])
        worst["traces_err"] = max(worst["traces_err"], r.get("traces_err", 0.0))
        worst["ok"] = worst["ok"] and r["ok"]
        worst["modes"] += 1
        for extra in ("base_err_bal", "base_err_plain"):
            if extra in r:
                worst[extra] = r[extra]
        if "prep_rows" in r:  # a float32 prep's worst row against the float64 prep
            worst["prep_row_err"] = max(worst.get("prep_row_err", 0.0), max(k for k, _ in r["prep_rows"].values()))
    emit({"phase": phase, "ok": all(r["ok"] for r in rows),
          "results": [dict(zip(shape_keys + ("dtype",), k), **v) for k, v in summary.items()]})


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    """Registers and spill bytes per kernel instantiation from ``ptxas -v``."""
    rows, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        f32_pert = m and re.search(r"sw_operator_f32_pert(_topo)?_kernelILi(\d+)E", m.group(1))
        adv = m and re.search(r"(euler3d_advection_interface|euler3d_advection_volume)_kernelI([df])Li(\d+)ELi(\d+)E",
                              m.group(1))
        adv_t = m and re.search(r"(euler3d_advection_tangent_(?:prep_node|prep_interface|interface|volume))_kernelI"
                                r"([df])Li(\d+)E(?:Li(\d+)E)?", m.group(1))
        cart = m and re.search(r"(euler_cartesian_operator|euler_cartesian_tangent|euler_cartesian_fv_tangent|"
                               r"euler_cartesian_fv)_kernelI([df])Li(\d+)E", m.group(1))
        if cart:
            fv = "fv" in cart.group(1)
            what = f"flux={('ausm', 'rusanov', 'upwind')[int(cart.group(3))]}" if fv else f"s={cart.group(3)}"
            current = {"kernel": f"{cart.group(1)} {'f64' if cart.group(2) == 'd' else 'f32'} {what}"}
            rows.append(current)
        elif adv_t:
            what = f"nt={adv_t.group(3)}" if adv_t.group(4) is None else f"s={adv_t.group(3)} nt={adv_t.group(4)}"
            current = {"kernel": f"{adv_t.group(1)} {'f64' if adv_t.group(2) == 'd' else 'f32'} {what}"}
            rows.append(current)
        elif adv:
            current = {"kernel": f"{adv.group(1)} {'f64' if adv.group(2) == 'd' else 'f32'} s={adv.group(3)} "
                                 f"nt={adv.group(4)}"}
            rows.append(current)
        elif f32_pert:
            name = "sw_operator_pert_topo f32 s={}" if f32_pert.group(1) else "sw_operator f32 s={} pert"
            current = {"kernel": name.format(f32_pert.group(2))}
            rows.append(current)
        elif m:
            k = re.search(r"(sw_operator_pert_topo|sw_operator_topo|sw_tangent_prep_topo|sw_tangent_apply_topo|"
                          r"sw_operator|sw_run|sw_edges|sw_tangent_prep|sw_tangent_apply|euler3d_operator|"
                          r"euler3d_interface|euler3d_volume|euler3d_tangent_prep|euler3d_tangent_apply|"
                          r"euler3d_tangent)_kernelI([df])Li(\d+)E(Lb([01])E)?(Lb([01])E)?", m.group(1))
            # The flags: PERT then TERRAIN (the 3D passes and prep; a source
            # without terrain has PERT only), TERRAIN alone (the 3D apply),
            # PERT alone (the others).
            flags = [f for f in (k.group(5), k.group(7)) if f is not None] if k else []
            pert = flags[:1] == ["1"] and not (k.group(1) == "euler3d_tangent_apply")
            terrain = (flags[1:] == ["1"] or (k is not None and k.group(1) == "euler3d_tangent_apply"
                                              and flags[:1] == ["1"]))
            current = {"kernel": f"{k.group(1)} {'f64' if k.group(2) == 'd' else 'f32'} s={k.group(3)}"
                       + (" pert" if pert else "") + (" terrain" if terrain else "") if k else m.group(1)}
            rows.append(current)
        elif current is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                current["stack_bytes"] = int(m.group(1))
                current["spill_store_bytes"] = int(m.group(2))
                current["spill_load_bytes"] = int(m.group(3))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                current["registers"] = int(m.group(1))
    return rows


def phase0(torch, smi):
    import sympy

    from wxfactory_tpu_torch.kernels import build

    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    build.build_all(KERNEL_SOURCES)
    seconds = time.perf_counter() - t0
    WORK.mkdir(parents=True, exist_ok=True)
    info = {name: build.build_info.get(name, {"seconds": 0.0, "log": ""}) for name in KERNEL_SOURCES}
    (WORK / "ptxas.log").write_text("".join(i["log"] for i in info.values()))
    emit({
        "phase": 0, "gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": next((l for l in nvcc if "release" in l), nvcc[-1]), "sympy": sympy.__version__,
        "python": sys.version.split()[0], "build_s": seconds,
        "nvcc_s": {name: i["seconds"] for name, i in info.items()},
        "built_now": all(bool(i["log"]) for i in info.values()),
        "ptxas": ptxas_summary("".join(i["log"] for i in info.values())),
    })


def phase1(torch):
    from wxfactory_tpu_torch.kernels.check import compare_sw_operator

    rows = []
    for nel, s in SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows += compare_sw_operator(nel, s, dtype, device="cuda")
    emit_comparison(1, rows, ("nel", "s"))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    main_path = [r for r in rows if (r["nel"], r["s"], r["dtype"]) == (64, 3, "float64")]
    return max(r["max_abs_err"] for r in main_path)


def phase2(torch):
    from wxfactory_tpu_torch.config import Configuration
    from wxfactory_tpu_torch.simulation import Simulation

    text = CASE6_INI.format(dt=30, t_end=600, nel=10, save=0, out=WORK / "phase2")
    states = {}
    for device in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            states[device] = Simulation(Configuration(text), device=device).run().cpu()
    want, got = states["cpu"], states["cuda"]
    scale = want.abs().reshape(3, -1).amax(dim=1).reshape(3, 1, 1, 1, 1)
    err = float(((got - want).abs() / scale).max())
    emit({"phase": 2, "steps": 20, "nel": 10, "s": 3, "dtype": "float64", "err": err, "tol": 1e-10,
          "ok": err <= 1e-10})
    if not err <= 1e-10:
        raise AssertionError(f"GPU and CPU runs differ by {err} of scale")


def reset_counts():
    """Set every kernel wrapper's launch count, the plain versions' call
    counts, the Jacobian actions asked of the matvec closures and the host
    syncs to 0."""
    from wxfactory_tpu_torch.common import device
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op
    from wxfactory_tpu_torch.ops import euler_cartesian_operator as ecop
    from wxfactory_tpu_torch.ops import sw_operator as swop
    from wxfactory_tpu_torch.solvers import matvec

    swop.launches = e3op.launches = e3op.tangent_launches = e3op.tangent_prep_launches = e3op.plain_tangent_calls = 0
    swop.pert_launches = swop.edge_launches = swop.halo_launches = swop.run_launches = swop.plain_calls = 0
    swop.state_launches = swop.tangent_prep_launches = swop.tangent_apply_launches = swop.plain_tangent_calls = 0
    swop.topo_launches = swop.topo_tangent_prep_launches = swop.topo_tangent_apply_launches = 0
    swop.pert_topo_launches = 0
    swop.s1_tangent_prep_launches = swop.s1_tangent_apply_launches = 0
    e3op.pert_launches = e3op.pert_stage_launches = e3op.pert_tangent_launches = e3op.plain_calls = 0
    swop.tile_launches = swop.pert_tile_launches = e3op.tile_launches = e3op.pert_tile_launches = 0
    e3op.terrain_launches = e3op.terrain_pert_launches = 0
    e3op.terrain_tangent_prep_launches = e3op.terrain_tangent_apply_launches = 0
    e3op.advection_launches = e3op.advection_tangent_prep_launches = e3op.advection_tangent_apply_launches = 0
    ecop.launches = ecop.tangent_launches = ecop.fv_launches = ecop.fv_tangent_launches = 0
    ecop.plain_calls = ecop.plain_tangent_calls = 0
    matvec.jacobian_actions = matvec.linearisations = device.host_syncs = 0


def read_counts():
    from wxfactory_tpu_torch.common import device
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op
    from wxfactory_tpu_torch.ops import euler_cartesian_operator as ecop
    from wxfactory_tpu_torch.ops import sw_operator as swop
    from wxfactory_tpu_torch.solvers import matvec

    return {"sw_operator": swop.launches, "sw_pert": swop.pert_launches, "sw_edges": swop.edge_launches,
            "sw_halo": swop.halo_launches, "sw_run": swop.run_launches, "sw_plain_calls": swop.plain_calls,
            "sw_state": swop.state_launches, "sw_tangent_prep": swop.tangent_prep_launches,
            "sw_tangent_apply": swop.tangent_apply_launches,
            "sw_plain_tangent_calls": swop.plain_tangent_calls,
            "sw_operator_topo": swop.topo_launches, "sw_pert_topo": swop.pert_topo_launches,
            "sw_tangent_prep_topo": swop.topo_tangent_prep_launches,
            "sw_tangent_apply_topo": swop.topo_tangent_apply_launches,
            "sw_tangent_prep_s1": swop.s1_tangent_prep_launches, "sw_tangent_apply_s1": swop.s1_tangent_apply_launches,
            "euler3d_operator": e3op.launches,
            "euler3d_tangent": e3op.tangent_launches, "euler3d_tangent_prep": e3op.tangent_prep_launches,
            "euler3d_pert": e3op.pert_launches,
            "euler3d_pert_stage": e3op.pert_stage_launches, "euler3d_pert_tangent": e3op.pert_tangent_launches,
            "euler3d_plain_calls": e3op.plain_calls, "plain_tangent_calls": e3op.plain_tangent_calls,
            "sw_tile": swop.tile_launches, "sw_pert_tile": swop.pert_tile_launches,
            "euler3d_tile": e3op.tile_launches, "euler3d_pert_tile": e3op.pert_tile_launches,
            "euler3d_terrain": e3op.terrain_launches, "euler3d_terrain_pert": e3op.terrain_pert_launches,
            "euler3d_terrain_tangent_prep": e3op.terrain_tangent_prep_launches,
            "euler3d_terrain_tangent_apply": e3op.terrain_tangent_apply_launches,
            "euler3d_advection": e3op.advection_launches,
            "euler3d_advection_tangent_prep": e3op.advection_tangent_prep_launches,
            "euler3d_advection_tangent_apply": e3op.advection_tangent_apply_launches,
            "euler_cartesian": ecop.launches, "euler_cartesian_tangent": ecop.tangent_launches,
            "euler_cartesian_fv": ecop.fv_launches, "euler_cartesian_fv_tangent": ecop.fv_tangent_launches,
            "euler_cartesian_plain_calls": ecop.plain_calls,
            "euler_cartesian_plain_tangent_calls": ecop.plain_tangent_calls,
            "jacobian_actions": matvec.jacobian_actions, "linearisations": matvec.linearisations,
            "host_syncs": device.host_syncs}


def phase3(torch):
    from wxfactory_tpu_torch import __main__ as cli
    from wxfactory_tpu_torch.output.state import load_state

    nsteps, nel = 360, 64
    out_dir = WORK / "phase3"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    ini = WORK / "case6_nel64_s3.ini"
    ini.write_text(CASE6_INI.format(dt=10, t_end=3600, nel=nel, save=nsteps, out=out_dir))

    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(ini), "--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["sw_operator"]
    text = log.getvalue()
    sys.stderr.write(text[-4000:])
    if rc != 0:
        raise AssertionError(f"main path exited with {rc}")
    want = {"sw_operator": 3 * nsteps, "sw_state": 3 * nsteps, "sw_halo": 0, "sw_edges": 0, "sw_pert": 0,
            "sw_plain_calls": 0}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"launches {got} in {nsteps} TVD-RK3 steps, expected {want}")
    drifts = [float(v) for v in re.findall(r"normalized error for mass = (\S+)", text)]
    if len(drifts) != 2 or not abs(drifts[-1]) < 1e-10:
        raise AssertionError(f"blockstats mass drift {drifts}")
    energy = [float(v) for v in re.findall(r"normalized error for energy = (\S+)", text)]
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    files = glob.glob(str(out_dir / f"state_vector_*.{nsteps:08d}.npy"))
    if len(files) != 1:
        raise AssertionError(f"checkpoint files {files}")
    state, config, version = load_state(files[0])
    if state.shape != (3, 6, nel, nel, 9) or not bool(torch.isfinite(torch.as_tensor(state)).all()):
        raise AssertionError(f"checkpoint state {state.shape} not finite or misshapen")
    emit({
        "phase": 3, "case": 6, "nel": nel, "s": 3, "points": 6 * nel * nel * 9, "dtype": "float64",
        "integrator": "tvdrk3", "dt": 10.0, "steps": int(run.group(1)), "run_s": float(run.group(2)),
        "steps_per_s": float(run.group(3)), "main_wall_s": wall, "launches": launches, "counts": got,
        "mass_drift": drifts[-1], "energy_drift": energy[-1], "checkpoint": Path(files[0]).name,
        "checkpoint_version": version,
    })
    return launches


def _event_times(torch, fn, n=20):
    """Milliseconds of ``n`` single calls, each between two CUDA events."""
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def phase4(torch, smi):
    from wxfactory_tpu_torch.kernels.check import case6_inputs
    from wxfactory_tpu_torch.ops import sw_operator as swop

    # The main path's calls: the state mode (halo=None), RHS and stage; the
    # halo-plane RHS, which the main path no longer runs, beside them.
    rows = []
    for dtype in (torch.float64, torch.float32):
        con, topology, x, y = case6_inputs(64, 3, dtype, "cuda")
        traces = swop.edge_traces(y, con)
        halo = swop.halo_from_traces(traces, topology)
        kernel = lambda: swop.sw_operator(y, None, con, topology=topology)
        plain = lambda: swop.sw_operator_plain(y, None, con, topology=topology)
        stage = lambda: swop.sw_operator(y, None, con, x=x, a=0.75, b=0.25, cdt=2.5, topology=topology)
        plane = lambda: swop.sw_operator(y, halo, con)
        glue = lambda: swop.halo_from_traces(traces, topology)
        for fn in (kernel, plain, stage, plane, glue):
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        k, p = [], []
        for fn, times in ((plain, p), (kernel, k), (kernel, k), (plain, p)):
            times.extend(_event_times(torch, fn))
        rows.append({
            "nel": 64, "s": 3, "dtype": str(dtype).replace("torch.", ""),
            "kernel_rhs_ms": statistics.median(k), "plain_rhs_ms": statistics.median(p),
            "kernel_stage_x_ms": statistics.median(_event_times(torch, stage)),
            "plane_rhs_ms": statistics.median(_event_times(torch, plane)),
            "halo_glue_ms": statistics.median(_event_times(torch, glue)),
            "calls_each": len(k),
        })
    emit({"phase": 4, "gpu": smi, "timing": "CUDA events, median per call; kernel_*: the state mode "
          "(halo=None), plane_rhs_ms: the operator fed a halo plane", "results": rows})


def phase5(torch):
    from wxfactory_tpu_torch.kernels.check import compare_euler3d_operator

    rows = []
    for nel_h, nel_v, s, case in E3_SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows += compare_euler3d_operator(nel_h, nel_v, s, dtype, device="cuda", case=case)
    emit_comparison(5, rows, ("nel_h", "nel_v", "s", "case"))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"3D kernel disagrees with its plain version: {bad}")
    main_path = [r for r in rows if (r["nel_h"], r["nel_v"], r["s"], r["dtype"]) == E3_MAIN + ("float64",)]
    return max(r["max_abs_err"] for r in main_path)


def phase6(torch):
    from wxfactory_tpu_torch.config import Configuration
    from wxfactory_tpu_torch.simulation import Simulation

    text = DCMIP31_INI.format(dt=2, t_end=20, s=2, nel_h=3, nel_v=2, save=0, out=WORK / "phase6",
                              integrator="tvdrk3", verbose=0)
    states = {}
    for device in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            states[device] = Simulation(Configuration(text), device=device).run().cpu()
    want, got = states["cpu"], states["cuda"]
    scale = want.abs().reshape(5, -1).amax(dim=1).reshape(5, 1, 1, 1, 1, 1)
    err = float(((got - want).abs() / scale).max())
    emit({"phase": 6, "case": 31, "steps": 10, "nel_h": 3, "nel_v": 2, "s": 2, "dtype": "float64", "err": err,
          "tol": 1e-10, "ok": err <= 1e-10})
    if not err <= 1e-10:
        raise AssertionError(f"GPU and CPU dcmip31 runs differ by {err} of scale")


def _dcmip31_run(torch, nel_h, nel_v, s, dt, nsteps, tag):
    """One dcmip31 run through the CLI on the card; checks launches, state,
    mass drift and checkpoints, returns its JSON row."""
    from wxfactory_tpu_torch import __main__ as cli
    from wxfactory_tpu_torch.kernels.check import euler3d_setup
    from wxfactory_tpu_torch.output import global_mass_3d
    from wxfactory_tpu_torch.output.state import load_state

    out_dir = WORK / f"phase7_{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    ini = WORK / f"dcmip31_{tag}.ini"
    ini.write_text(DCMIP31_INI.format(dt=dt, t_end=dt * nsteps, s=s, nel_h=nel_h, nel_v=nel_v, save=nsteps,
                                      out=out_dir, integrator="tvdrk3", verbose=0))
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(ini), "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = read_counts()["euler3d_operator"]
    text = log.getvalue()
    sys.stderr.write(text[-2000:])
    if rc != 0:
        raise AssertionError(f"3D main path ({tag}) exited with {rc}")
    if launches != 3 * nsteps:
        raise AssertionError(f"{launches} kernel launches in {nsteps} TVD-RK3 steps, expected {3 * nsteps}")
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    states = {}
    for step in (0, nsteps):
        files = glob.glob(str(out_dir / f"state_vector_*.{step:08d}.npy"))
        if len(files) != 1:
            raise AssertionError(f"checkpoint files {files}")
        states[step], _, version = load_state(files[0])
    q = states[nsteps]
    shape = (5, 6, nel_v, nel_h, nel_h, s**3)
    if q.shape != shape or not bool(torch.isfinite(torch.as_tensor(q)).all()):
        raise AssertionError(f"checkpoint state {q.shape} not finite or misshapen")
    _, ops, metric, _, _ = euler3d_setup(nel_h, nel_v, s, 31)
    m0, m1 = global_mass_3d(states[0], ops, metric), global_mass_3d(q, ops, metric)
    drift = (m1 - m0) / m0
    if not abs(drift) < 1e-11:
        raise AssertionError(f"mass drift {drift} over {nsteps} steps")
    run_s = float(run.group(2))
    return {
        "case": 31, "nel_h": nel_h, "nel_v": nel_v, "s": s, "points": 6 * nel_v * nel_h * nel_h * s**3,
        "dtype": "float64", "integrator": "tvdrk3", "dt": dt, "steps": int(run.group(1)),
        "simulated_s": dt * nsteps, "setup_s": wall - run_s, "run_s": run_s,
        "steps_per_s": float(run.group(3)), "main_wall_s": wall, "launches": launches,
        "mass_drift": drift, "max_abs_w": float(abs(q[3] / q[0]).max()),
        "checkpoint": Path(files[0]).name, "checkpoint_version": version,
    }


def phase7(torch):
    main = _dcmip31_run(torch, *E3_MAIN, dt=0.1, nsteps=100, tag="main")
    canonical = _dcmip31_run(torch, 12, 3, 2, dt=0.5, nsteps=75, tag="canonical")
    emit({"phase": 7, "results": [main, canonical]})
    return main["launches"]


def phase8(torch, smi):
    """Timing at E3_MAIN: the operator kernel's RHS and stage + x + traces
    (the card's time a call, 20 calls queued behind a sleep kernel, in
    turns), the plain RHS and the halo glue (CUDA events around single
    calls, median; the kernel's too, which adds the host's time a call),
    beside the bound; the registers, spills, shared memory a block and
    resident blocks an SM of the operator's two kernels (absolute and
    perturbation mode) and their launch geometry."""
    from wxfactory_tpu_torch.kernels.check import euler3d_inputs, euler3d_work, operator_kernel_resources
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op

    rows = []
    for dtype in (torch.float64, torch.float32):
        con, topology, x, y = euler3d_inputs(*E3_MAIN, dtype, "cuda")
        traces = e3op.edge_traces(y, con)
        halo = e3op.halo_from_traces(traces, topology)
        kernel = lambda: e3op.euler3d_operator(y, halo, con)
        plain = lambda: e3op.euler3d_operator_plain(y, halo, con)
        stage = lambda: e3op.euler3d_operator(y, halo, con, x=x, a=0.75, b=0.25, cdt=0.025, emit_traces=True)
        glue = lambda: e3op.halo_from_traces(traces, topology)
        for fn in (kernel, plain, stage, glue):
            for _ in range(2):
                fn()
        torch.cuda.synchronize()
        times = {"rhs": [], "stage": []}
        for key, fn in (("rhs", kernel), ("stage", stage), ("stage", stage), ("rhs", kernel)):
            times[key].append(_device_ms(torch, fn, 20))
        p = _event_times(torch, plain, n=10)
        name = str(dtype).replace("torch.", "")
        row = {"nel_h": E3_MAIN[0], "nel_v": E3_MAIN[1], "s": E3_MAIN[2], "dtype": name,
               "kernel_rhs_ms": statistics.median(times["rhs"]), "kernel_rhs_ms_turns": times["rhs"],
               "kernel_stage_traces_ms": statistics.median(times["stage"]),
               "kernel_stage_traces_ms_turns": times["stage"], "plain_rhs_ms": statistics.median(p),
               "kernel_rhs_event_ms": statistics.median(_event_times(torch, kernel, n=10)),
               "halo_glue_ms": statistics.median(_event_times(torch, glue)),
               "resources": operator_kernel_resources(dtype, E3_MAIN[2]),
               "plan": e3op.operator_plan(*E3_MAIN, 6)}
        for mode, kw in (("rhs", {}), ("stage_traces", dict(stage=True, use_x=True, traces=True))):
            nbytes, ops = euler3d_work(con, **kw)
            bound = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": ops / PEAK_FLOPS[name] * 1e3}
            row[f"{mode}_bytes"], row[f"{mode}_ops"] = nbytes, ops
            row[f"{mode}_bound_ms"] = max(bound.values())
            row[f"{mode}_bound_by"] = max(bound, key=bound.get)
        rows.append(row)
    emit({"phase": 8, "gpu": smi, "timing": "kernel: the card's time a call (20 calls queued behind a sleep "
          "kernel, CUDA events), in turns; plain, glue and *_event_ms: CUDA events around single calls, median",
          "results": rows})
    return rows[0]


def phase9(torch):
    from wxfactory_tpu_torch.kernels.check import compare_euler3d_tangent

    rows = []
    for nel_h, nel_v, s, case in E3_SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows.append(compare_euler3d_tangent(nel_h, nel_v, s, dtype, device="cuda", case=case))
    emit_comparison(9, rows, ("nel_h", "nel_v", "s", "case"))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"tangent kernels disagree with their plain versions: {bad}")
    main_path = [r for r in rows if (r["nel_h"], r["nel_v"], r["s"], r["dtype"]) == E3_MAIN + ("float64",)]
    return {"euler3d_tangent_prep": max(r["prep_max_abs_err"] for r in main_path),
            "euler3d_tangent_apply": max(r["apply_max_abs_err"] for r in main_path)}


KRYLOV_LINE = re.compile(r"kiops converged at iteration (\d+) \((\d+) substeps, (\d+) rejected\) "
                         r"local error (\S+), last Krylov size (\d+)")


def phase10(torch):
    """The same EPI2 run on the GPU (tangent kernel) and on the CPU (plain
    tangent): the Krylov statistics of every step and the final states."""
    from wxfactory_tpu_torch.config import Configuration
    from wxfactory_tpu_torch.simulation import Simulation

    nsteps = 2
    text = DCMIP31_INI.format(dt=30, t_end=30 * nsteps, s=2, nel_h=4, nel_v=2, save=0, out=WORK / "phase10",
                              integrator="epi2", verbose=1)
    states, stats = {}, {}
    for device in ("cuda", "cpu"):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            states[device] = Simulation(Configuration(text), device=device).run().cpu()
        stats[device] = [tuple(int(m.group(i)) for i in (1, 2, 3, 5)) for m in KRYLOV_LINE.finditer(log.getvalue())]
    want, got = states["cpu"], states["cuda"]
    scale = want.abs().reshape(5, -1).amax(dim=1).reshape(5, 1, 1, 1, 1, 1)
    err = float(((got - want).abs() / scale).max())
    same = stats["cuda"] == stats["cpu"] and len(stats["cpu"]) == nsteps
    emit({"phase": 10, "case": 31, "integrator": "epi2", "steps": nsteps, "nel_h": 4, "nel_v": 2, "s": 2,
          "dtype": "float64", "krylov_gpu": stats["cuda"], "krylov_cpu": stats["cpu"],
          "krylov_columns": ["iterations", "substeps", "rejected", "last_krylov_size"], "same_krylov": same,
          "err": err, "tol": 1e-10, "ok": same and err <= 1e-10})
    if not same:
        raise AssertionError(f"GPU and CPU EPI2 runs differ in Krylov statistics: {stats}")
    if not err <= 1e-10:
        raise AssertionError(f"GPU and CPU EPI2 runs differ by {err} of scale")


def _epi2_run(torch, nel_h, nel_v, s, nsteps, tag, profile_steps):
    """One dcmip31 EPI2+KIOPS run through ``Simulation(ini).run()``, the
    CLI's own call, on the card; checks the launch counts, state, mass drift
    and checkpoints, then profiles ``profile_steps`` steps of the same
    Simulation from its initial state; returns its JSON row."""
    from wxfactory_tpu_torch.output import global_mass_3d
    from wxfactory_tpu_torch.output.state import load_state
    from wxfactory_tpu_torch.profile import profile_simulation
    from wxfactory_tpu_torch.simulation import Simulation

    dt = 30.0
    out_dir = WORK / f"phase11_{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    ini = WORK / f"dcmip31_epi2_{tag}.ini"
    ini.write_text(DCMIP31_INI.format(dt=dt, t_end=dt * nsteps, s=s, nel_h=nel_h, nel_v=nel_v, save=1,
                                      out=out_dir, integrator="epi2", verbose=1))
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        sim = Simulation(str(ini), device="cuda")
        sim.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = log.getvalue()
    sys.stderr.write(text[-3000:])
    krylov = [tuple(int(m.group(i)) for i in (1, 2, 3, 5)) for m in KRYLOV_LINE.finditer(text)]
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    if run is None:
        raise AssertionError(f"EPI2 main path ({tag}) did not complete; Krylov statistics per step "
                             f"(iterations, substeps, rejected, last size): {krylov}")
    if counts["euler3d_operator"] != nsteps:
        raise AssertionError(f"{counts['euler3d_operator']} RHS-kernel launches in {nsteps} EPI2 steps")
    if counts["euler3d_tangent"] != counts["jacobian_actions"] or counts["jacobian_actions"] == 0:
        raise AssertionError(f"tangent apply launches {counts['euler3d_tangent']} != Jacobian actions "
                             f"{counts['jacobian_actions']}")
    if counts["euler3d_tangent_prep"] != nsteps:  # one linearisation point a step
        raise AssertionError(f"{counts['euler3d_tangent_prep']} tangent prep launches in {nsteps} EPI2 steps")
    if counts["plain_tangent_calls"] != 0 or counts["euler3d_plain_calls"] != 0:
        raise AssertionError(f"plain calls on the card: {counts}")
    if len(krylov) != nsteps or sum(k[0] for k in krylov) != counts["jacobian_actions"]:
        raise AssertionError(f"Krylov statistics {krylov} do not account for {counts['jacobian_actions']} actions")
    ops, metric = sim.ops, sim.metric
    masses = []
    for step in range(nsteps + 1):
        files = glob.glob(str(out_dir / f"state_vector_*.{step:08d}.npy"))
        if len(files) != 1:
            raise AssertionError(f"checkpoint files {files}")
        q, _, version = load_state(files[0])
        masses.append(global_mass_3d(q, ops, metric))
    if q.shape != (5, 6, nel_v, nel_h, nel_h, s**3) or not bool(torch.isfinite(torch.as_tensor(q)).all()):
        raise AssertionError(f"checkpoint state {q.shape} not finite or misshapen")
    drifts = [(m - masses[0]) / masses[0] for m in masses[1:]]
    # KIOPS forms the first step's update from a Krylov combination that
    # cancels ~12 orders of magnitude at the balanced initial state, so
    # round-off of the (conservative) basis leaves a mass jump of a few
    # 1e-8 in the JAX package and the port alike (tools/epi2_mass_drift.py);
    # later steps move mass at ~1e-11. The gate is the KIOPS tolerance.
    drift = drifts[-1]
    if not max(abs(d) for d in drifts) < 1e-7:
        raise AssertionError(f"mass drift {drifts} over {nsteps} EPI2 steps")
    with contextlib.redirect_stdout(io.StringIO()):
        prof = profile_simulation(sim, steps=profile_steps, warmup=1)
    run_s = float(run.group(2))
    return {
        "case": 31, "nel_h": nel_h, "nel_v": nel_v, "s": s, "points": 6 * nel_v * nel_h * nel_h * s**3,
        "dtype": "float64", "integrator": "epi2", "exponential_solver": "kiops", "tolerance": 1e-7, "dt": dt,
        "steps": int(run.group(1)), "simulated_s": dt * nsteps, "setup_s": wall - run_s, "run_s": run_s,
        "steps_per_s": float(run.group(3)), "main_wall_s": wall, "rhs_launches": counts["euler3d_operator"],
        "tangent_launches": counts["euler3d_tangent"], "tangent_prep_launches": counts["euler3d_tangent_prep"],
        "jacobian_actions": counts["jacobian_actions"], "plain_tangent_calls": counts["plain_tangent_calls"],
        "krylov_iterations": sum(k[0] for k in krylov), "substeps": sum(k[1] for k in krylov),
        "rejected": sum(k[2] for k in krylov), "last_krylov_size": krylov[-1][3],
        "krylov_per_step": krylov, "mass_drift": drift, "mass_drift_per_step": drifts,
        "mass_drift_after_step_1": (masses[-1] - masses[1]) / masses[1], "max_abs_w": float(abs(q[3] / q[0]).max()),
        "profiled_steps": profile_steps, "profiled_step_ms": prof["profiled_step_ms"],
        "device_busy_share": prof["device_busy_share"],
        "tangent_share_of_device_time": prof["tangent_kernel_us_per_step"] / prof["device_busy_us_per_step"],
        "profile_device_launches_per_step": prof["device_launches_per_step"],
        "profile_kernels_us_per_step": prof["kernels_us_per_step"][:6],
        "checkpoint": Path(files[0]).name, "checkpoint_version": version,
    }


def phase11(torch):
    canonical = _epi2_run(torch, 12, 3, 2, nsteps=5, tag="canonical", profile_steps=3)
    main = _epi2_run(torch, *E3_MAIN, nsteps=3, tag="main", profile_steps=1)
    emit({"phase": 11, "results": [canonical, main]})
    return {"euler3d_tangent_apply": main["tangent_launches"], "euler3d_tangent_prep": main["tangent_prep_launches"]}


def _tangent_timing(torch, pert_form: bool):
    """Per dtype at E3_MAIN, in turns: the prep and apply kernels (the
    card's time a call) and their plain versions, the plain tangent
    (torch.func.jvp), the tangent glue and the RHS kernel of the same form
    (CUDA events around single calls, median; the apply's too, which adds
    the host's time a call); beside the function's bound, the apply's own
    bytes floor, the prep's bound, and the registers, spills, shared memory
    and resident blocks of the kernels."""
    from wxfactory_tpu_torch.kernels.check import (euler3d_pert_inputs, euler3d_pert_work, euler3d_tangent_apply_work,
                                                   euler3d_tangent_inputs, euler3d_tangent_prep_work,
                                                   euler3d_tangent_work, pert_halos, tangent_halos,
                                                   tangent_kernel_resources)
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op

    rows = []
    for dtype in (torch.float64, torch.float32):
        if pert_form:
            con, topology, pert, q, v = euler3d_pert_inputs(*E3_MAIN, dtype, "cuda")
            halo_q, halo_v = pert_halos(q, v, pert, con, topology)
            qa, traces = pert.q0 + q, pert.traces0 + e3op.edge_traces_delta(q, pert, con)
            jvp = lambda: e3op.euler3d_tangent_pert_plain(q, v, halo_q, halo_v, con, pert)
        else:
            con, topology, q, v = euler3d_tangent_inputs(*E3_MAIN, dtype, "cuda")
            pert, (halo_q, halo_v) = None, tangent_halos(q, v, con, topology)
            qa, traces = q, e3op.edge_traces(q, con)
            jvp = lambda: e3op.euler3d_tangent_plain(q, v, halo_q, halo_v, con)
        coef = e3op.euler3d_tangent_prep(q, halo_q, con, pert)
        fns = {
            "prep": lambda: e3op.euler3d_tangent_prep(q, halo_q, con, pert),
            "apply": lambda: e3op.euler3d_tangent_apply(v, halo_v, coef, con),
            "prep_plain": lambda: e3op.euler3d_tangent_prep_plain(q, halo_q, con, pert),
            "apply_plain": lambda: e3op.euler3d_tangent_apply_plain(v, halo_v, coef, con),
            "jvp_plain": jvp,
        }
        glue = lambda: e3op.halo_from_traces(e3op.edge_traces_tangent(qa, v, con, traces), topology)
        rhs = lambda: e3op.euler3d_operator(q, halo_q, con, pert=pert)
        for fn in list(fns.values()) + [glue, rhs]:
            for _ in range(2):
                fn()
        torch.cuda.synchronize()
        # The kernels: the card's time a call, 20 calls queued behind a sleep
        # kernel, twice each in turns; the plain versions: single calls
        # between CUDA events, median.
        times = {k: [] for k in fns}
        order = list(fns)
        for key in order + order[::-1]:
            plain = key.endswith("plain")
            times[key].extend(_event_times(torch, fns[key], n=5) if plain else [_device_ms(torch, fns[key], 20)])
        name = str(dtype).replace("torch.", "")
        row = {"nel_h": E3_MAIN[0], "nel_v": E3_MAIN[1], "s": E3_MAIN[2], "dtype": name,
               "form": "perturbation" if pert_form else "absolute",
               **{f"{k}_ms": statistics.median(t) for k, t in times.items()},
               "prep_ms_turns": times["prep"], "apply_ms_turns": times["apply"],
               "apply_event_ms": statistics.median(_event_times(torch, fns["apply"])),
               "glue_ms": statistics.median(_event_times(torch, glue)),
               "rhs_kernel_ms": statistics.median(_event_times(torch, rhs))}
        work = {"function": euler3d_pert_work(con, tangent=True) if pert_form else euler3d_tangent_work(con),
                "apply": euler3d_tangent_apply_work(con), "prep": euler3d_tangent_prep_work(con, pert_form)}
        for key, (nbytes, ops) in work.items():
            bound = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": ops / PEAK_FLOPS[name] * 1e3}
            row[f"{key}_bytes"], row[f"{key}_ops"] = nbytes, ops
            row[f"{key}_bound_ms"] = max(bound.values())
            row[f"{key}_bound_by"] = max(bound, key=bound.get)
        resources = tangent_kernel_resources(dtype, E3_MAIN[2])
        row["resources"] = {"prep": resources["pert_prep" if pert_form else "prep"], "apply": resources["apply"]}
        rows.append(row)
        del coef, fns
        torch.cuda.empty_cache()
    return rows


def phase12(torch, smi):
    rows = _tangent_timing(torch, pert_form=False)
    emit({"phase": 12, "gpu": smi, "timing": "kernels: the card's time a call (20 calls queued behind a sleep "
          "kernel, CUDA events), in turns; the rest and *_event_ms: CUDA events around single calls, median",
          "results": rows})
    return rows[0]


def phase13(torch):
    from wxfactory_tpu_torch.kernels.check import compare_euler3d_pert

    rows = []
    for nel_h, nel_v, s, case in E3_SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows += compare_euler3d_pert(nel_h, nel_v, s, dtype, device="cuda", case=case)
    emit_comparison(13, rows, ("nel_h", "nel_v", "s", "case"))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"perturbation kernel disagrees with its plain version: {bad}")
    main_path = [r for r in rows if (r["nel_h"], r["nel_v"], r["s"], r["dtype"], r["mode"]) ==
                 E3_MAIN + ("float32", "pert_tangent")]
    return {"euler3d_pert_tangent_prep": max(r["prep_max_abs_err"] for r in main_path),
            "euler3d_pert_tangent_apply": max(r["apply_max_abs_err"] for r in main_path)}


KIOPS_JIT_LINE = re.compile(r"kiops_jit converged at iteration (\d+) \((\d+) substeps, (\d+) rejected\) "
                            r"local error (\S+), last Krylov size (\d+), (\d+) controls, (\d+) masked, "
                            r"(\d+) matvecs")


def kiops_jit_ini(mixed: int, chunk: int, **kw) -> str:
    return DCMIP31_INI.format(integrator="epi2", **kw).replace(
        "exponential_solver = kiops",
        f"exponential_solver = kiops_jit\nmixed_precision_krylov = {mixed}\ndevice_step_chunk = {chunk}")


def phase14(torch):
    """The same EPI2 kiops_jit runs on the GPU (kernels) and on the CPU
    (plain versions): float64 at 4x2x2, s=2 with identical Krylov
    statistics; mixed precision at 4x2x4, s=4, the shape at which the JAX
    package holds its two float32 companions to 2e-5 (at 4x2x2, s=2 two
    float32 operators part by ~2e-4 of rho*w's max after two steps, the JAX
    package's own two as much: the distance there is reported, not gated)."""
    from wxfactory_tpu_torch.common.device import forbid_uncounted_syncs
    from wxfactory_tpu_torch.config import Configuration
    from wxfactory_tpu_torch.simulation import Simulation

    nsteps, results = 2, []
    for mixed, s, tol in ((0, 2, 1e-10), (1, 4, 2e-5), (1, 2, None)):
        text = kiops_jit_ini(mixed, 1, dt=30, t_end=30 * nsteps, s=s, nel_h=4, nel_v=2, save=0,
                             out=WORK / "phase14", verbose=1)
        states, stats = {}, {}
        for device in ("cuda", "cpu"):
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                sim = Simulation(Configuration(text), device=device)
                with forbid_uncounted_syncs():
                    states[device] = sim.run()
            states[device] = states[device].cpu()
            stats[device] = [tuple(int(m.group(i)) for i in (1, 2, 3, 5)) for m in
                             KIOPS_JIT_LINE.finditer(log.getvalue())]
        want, got = states["cpu"], states["cuda"]
        scale = want.abs().reshape(5, -1).amax(dim=1).reshape(5, 1, 1, 1, 1, 1)
        err = float(((got - want).abs() / scale).max())
        same = stats["cuda"] == stats["cpu"] and len(stats["cpu"]) == nsteps
        ok = tol is None or (err <= tol and (same or mixed))
        results.append({"mixed_precision_krylov": mixed, "nel_h": 4, "nel_v": 2, "s": s,
                        "krylov_gpu": stats["cuda"], "krylov_cpu": stats["cpu"], "same_krylov": same, "err": err,
                        "tol": tol, "ok": ok})
    emit({"phase": 14, "case": 31, "integrator": "epi2", "exponential_solver": "kiops_jit", "steps": nsteps,
          "krylov_columns": ["iterations", "substeps", "rejected", "last_krylov_size"], "results": results,
          "ok": all(r["ok"] for r in results)})
    if not all(r["ok"] for r in results):
        raise AssertionError(f"GPU and CPU kiops_jit EPI2 runs differ: {results}")


def _kiops_jit_run(torch, nel_h, nel_v, s, nsteps, mixed, tag, profile_steps, chunk=5):
    """One dcmip31 EPI2 kiops_jit run (chunks of ``chunk`` steps, a
    checkpoint at each chunk's end) through ``Simulation(ini).run()``, the
    CLI's own call, on the card, with every wait of the host for the card
    but the counted ones raising (``forbid_uncounted_syncs``); checks the
    launch counts, syncs, state, mass drift at every checkpoint and the
    checkpoints, then profiles ``profile_steps`` steps of the same
    Simulation from its initial state (none when 0); returns its JSON row."""
    from wxfactory_tpu_torch.common.device import forbid_uncounted_syncs
    from wxfactory_tpu_torch.output import global_mass_3d
    from wxfactory_tpu_torch.output.state import load_state
    from wxfactory_tpu_torch.profile import profile_simulation
    from wxfactory_tpu_torch.simulation import Simulation

    dt = 30.0
    out_dir = WORK / f"phase15_{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    ini = WORK / f"dcmip31_kiops_jit_{tag}.ini"
    ini.write_text(kiops_jit_ini(mixed, chunk, dt=dt, t_end=dt * nsteps, s=s, nel_h=nel_h, nel_v=nel_v,
                                 save=chunk, out=out_dir, verbose=1))
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        sim = Simulation(str(ini), device="cuda")
        with forbid_uncounted_syncs():
            sim.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = log.getvalue()
    sys.stderr.write(text[-3000:])
    krylov = [tuple(int(m.group(i)) for i in (1, 2, 3, 5, 6, 7, 8)) for m in KIOPS_JIT_LINE.finditer(text)]
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    if run is None:
        raise AssertionError(f"kiops_jit main path ({tag}) did not complete; Krylov statistics {krylov}")
    if "no effect" in text or "cannot consume" in text:
        raise AssertionError("mixed_precision_krylov was flagged as having no effect")
    # Mixed: one float64 RHS a step plus the float64 base RHS of the
    # companion at setup; every Krylov matvec is the perturbation tangent.
    tangent = "euler3d_pert_tangent" if mixed else "euler3d_tangent"
    if counts["euler3d_operator"] != nsteps + mixed:
        raise AssertionError(f"{counts['euler3d_operator']} RHS-kernel launches in {nsteps} steps")
    if counts[tangent] != counts["jacobian_actions"] or counts["jacobian_actions"] == 0:
        raise AssertionError(f"{tangent} launches {counts[tangent]} != Jacobian actions {counts['jacobian_actions']}")
    # One linearisation point a step: the companion's (mixed) or the float64 RHS's.
    if counts["euler3d_tangent_prep"] != nsteps:
        raise AssertionError(f"{counts['euler3d_tangent_prep']} tangent prep launches in {nsteps} steps")
    if counts["euler3d_tangent" if mixed else "euler3d_pert_tangent"] or counts["euler3d_pert"]:
        raise AssertionError(f"launches of another mode: {counts}")
    if counts["plain_tangent_calls"] != 0 or counts["euler3d_plain_calls"] != 0:
        raise AssertionError(f"plain calls on the card: {counts}")
    controls = sum(k[4] for k in krylov)
    if len(krylov) != nsteps or sum(k[6] for k in krylov) != counts["jacobian_actions"]:
        raise AssertionError(f"Krylov statistics {krylov} do not account for {counts['jacobian_actions']} actions")
    # Counted waits: the controls, a NaN guard and a checkpoint a chunk, and
    # outside the steps the initial checkpoint and the run's final
    # synchronize. No other wait can have happened: forbid_uncounted_syncs
    # would have raised. The steps may wait the controls + 2 times a step.
    step_syncs = counts["host_syncs"] - 2
    if step_syncs > controls + 2 * nsteps:
        raise AssertionError(f"{step_syncs} host syncs for {controls} Krylov controls in {nsteps} steps")
    ops, metric = sim.ops, sim.metric
    masses = {}
    for step in range(0, nsteps + 1, chunk):
        files = glob.glob(str(out_dir / f"state_vector_*.{step:08d}.npy"))
        if len(files) != 1:
            raise AssertionError(f"checkpoint files {files}")
        q, _, version = load_state(files[0])
        masses[step] = global_mass_3d(q, ops, metric)
    if q.shape != (5, 6, nel_v, nel_h, nel_h, s**3) or not bool(torch.isfinite(torch.as_tensor(q)).all()):
        raise AssertionError(f"checkpoint state {q.shape} not finite or misshapen")
    drifts = {k: (m - masses[0]) / masses[0] for k, m in masses.items() if k}
    if not max(abs(d) for d in drifts.values()) < 1e-7:
        raise AssertionError(f"mass drift {drifts} over {nsteps} steps")
    run_s = float(run.group(2))
    row = {
        "case": 31, "nel_h": nel_h, "nel_v": nel_v, "s": s, "points": 6 * nel_v * nel_h * nel_h * s**3,
        "dtype": "float64", "integrator": "epi2", "exponential_solver": "kiops_jit", "mixed_precision_krylov": mixed,
        "device_step_chunk": chunk, "tolerance": 1e-7, "dt": dt, "steps": int(run.group(1)),
        "setup_s": wall - run_s, "run_s": run_s, "steps_per_s": float(run.group(3)), "main_wall_s": wall,
        "rhs_launches": counts["euler3d_operator"], "tangent_launches": counts[tangent],
        "tangent_prep_launches": counts["euler3d_tangent_prep"],
        "jacobian_actions": counts["jacobian_actions"], "plain_tangent_calls": counts["plain_tangent_calls"],
        "krylov_iterations": sum(k[0] for k in krylov), "substeps": sum(k[1] for k in krylov),
        "rejected": sum(k[2] for k in krylov), "controls": controls, "masked_iterations": sum(k[5] for k in krylov),
        "last_krylov_size": krylov[-1][3], "krylov_per_step": [k[:3] for k in krylov],
        "host_syncs": counts["host_syncs"], "host_syncs_per_step": step_syncs / nsteps,
        "controls_per_step": controls / nsteps, "mass_drift_per_checkpoint": drifts,
        "max_abs_w": float(abs(q[3] / q[0]).max()), "profiled_steps": profile_steps,
        "checkpoint": Path(files[0]).name, "checkpoint_version": version,
    }
    if not profile_steps:
        return row
    # The run's own Simulation, from its initial state again (EPI2 carries
    # nothing from step to step).
    with contextlib.redirect_stdout(io.StringIO()):
        prof = profile_simulation(sim, steps=profile_steps, warmup=1)
    iters = prof["krylov_iterations_per_step"] or 1.0
    return dict(
        row, profiled_step_ms=prof["profiled_step_ms"], device_busy_share=prof["device_busy_share"],
        profile_krylov_iterations_per_step=prof["krylov_iterations_per_step"],
        profile_us_per_iteration={k: v / iters for k, v in prof["classes_us_per_step"].items()},
        profile_step_ms_per_iteration=prof["profiled_step_ms"] / iters,
        profile_device_launches_per_step=prof["device_launches_per_step"],
        profile_device_launches_per_iteration=prof["device_launches_per_step"] / iters,
        profile_host_syncs_per_step=prof["host_syncs_per_step"],
        profile_kernels_us_per_step=prof["kernels_us_per_step"][:6],
    )


def phase15(torch):
    rows = [
        _kiops_jit_run(torch, 12, 3, 2, nsteps=10, mixed=1, tag="canonical_mixed", profile_steps=3),
        # Mass at every step: chunks of one, a checkpoint after each.
        _kiops_jit_run(torch, 12, 3, 2, nsteps=10, mixed=1, tag="canonical_mixed_every_step", profile_steps=0,
                       chunk=1),
        _kiops_jit_run(torch, *E3_MAIN, nsteps=5, mixed=1, tag="main_mixed", profile_steps=1),
        _kiops_jit_run(torch, 12, 3, 2, nsteps=5, mixed=0, tag="canonical_f64", profile_steps=3),
        _kiops_jit_run(torch, *E3_KRYLOV_MAIN, nsteps=5, mixed=0, tag="main_f64", profile_steps=0),
    ]
    emit({"phase": 15, "results": rows})
    return {"euler3d_pert_tangent_apply": rows[2]["tangent_launches"],
            "euler3d_pert_tangent_prep": rows[2]["tangent_prep_launches"]}


def _arnoldi_ms(torch, matvec, vec, basis_dtype, full_ortho, m=64):
    """Milliseconds an Arnoldi iteration over one kiops_jit cycle of ``m``
    iterations (a small tau_end so the first control accepts), between CUDA
    events, with its statistics; the timed call under
    ``forbid_uncounted_syncs``."""
    from wxfactory_tpu_torch.common.device import forbid_uncounted_syncs
    from wxfactory_tpu_torch.solvers.kiops_jit import kiops_jit

    run = lambda: kiops_jit(matvec, vec, tau_end=1e-3, tol=1e-7, m_init=m, mmin=m, mmax=m,
                            full_ortho=full_ortho, basis_dtype=basis_dtype)
    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    with forbid_uncounted_syncs():
        _, stats = run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (stats.krylov_steps + stats.masked_iterations), stats


def phase16(torch, smi):
    from wxfactory_tpu_torch.kernels.check import euler3d_pert_inputs, euler3d_pert_work, euler3d_setup
    from wxfactory_tpu_torch.models import Euler3DRHS
    from wxfactory_tpu_torch.solvers.matvec import make_jvp_matvec

    rows = _tangent_timing(torch, pert_form=True)
    for row, dtype in zip(rows, (torch.float64, torch.float32)):
        nbytes, ops = euler3d_pert_work(euler3d_pert_inputs(*E3_MAIN, dtype, "cuda")[0])
        bound = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": ops / PEAK_FLOPS[row["dtype"]] * 1e3}
        row["pert_rhs_bytes"], row["pert_rhs_ops"] = nbytes, ops
        row["pert_rhs_bound_ms"], row["pert_rhs_bound_by"] = max(bound.values()), max(bound, key=bound.get)

    # One Arnoldi iteration of each kiops_jit variant on the main path's
    # operators at the initial state (EPI2's first step, dt = 30 s).
    geom, ops, metric, topology, q0 = euler3d_setup(*E3_MAIN, 31)
    rhs = Euler3DRHS(geom, ops, metric, dtype=torch.float64, device="cuda", topology=topology)
    rhs32 = Euler3DRHS(geom, ops, metric, dtype=torch.float32, device="cuda", topology=topology, perturbation_base=q0)
    q = torch.as_tensor(q0, device="cuda")
    rhs_q = rhs(q).reshape(-1)
    vec = torch.stack([torch.zeros_like(rhs_q), rhs_q])
    mv64, mv32 = make_jvp_matvec(rhs, q, 30.0), make_jvp_matvec(rhs32, q.float(), 30.0)
    arnoldi = {}
    for variant, (mv, bd, fo) in {"float64_iop2": (mv64, None, False),
                                  "mixed_cgs2": (mv32, torch.float32, True)}.items():
        ms, st = _arnoldi_ms(torch, mv, vec, bd, fo)
        arnoldi[variant] = {"ms_per_iteration": ms, "iterations": st.krylov_steps + st.masked_iterations,
                            "controls": st.controls}
    emit({"phase": 16, "gpu": smi, "timing": "as phase 12; Arnoldi: one 64-iteration cycle",
          "results": rows, "arnoldi": arnoldi})
    return rows[1]


def phase17(torch):
    """The SW perturbation mode, halo and edge-trace kernels against their
    plain versions; the whole-run kernel against its plain loop and the
    chained per-stage kernels."""
    from wxfactory_tpu_torch.kernels.check import compare_sw_edges, compare_sw_halo, compare_sw_pert, compare_sw_run

    rows = []
    for nel, s in SW_PERT_SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows += compare_sw_pert(nel, s, dtype, device="cuda")
            rows += compare_sw_halo(nel, s, dtype, device="cuda") + compare_sw_edges(nel, s, dtype, device="cuda")
    runs = [compare_sw_run(nel, dtype, nsteps, pert, device="cuda")
            for nel in (32, 64) for dtype in (torch.float64, torch.float32)
            for pert in (False, True) for nsteps in (1, 2, 3)]
    emit_comparison(17, rows + runs, ("nel", "s"))
    keys = ("nel", "dtype", "mode", "nsteps", "err", "plain_err", "chain_err", "chain_max_abs_err", "bit_identical",
            "tol", "ok")
    emit({"phase": "17_whole_run", "ok": all(r["ok"] for r in runs),
          "bit_identical": sum(r["bit_identical"] for r in runs), "runs": len(runs),
          "results": [{k: r[k] for k in keys if k in r} for r in runs]})
    bad = [r for r in rows + runs if not r["ok"]]
    if bad:
        raise AssertionError(f"SW kernels disagree with their plain versions: {bad}")
    main = lambda rs, mode: max(r["max_abs_err"] for r in rs
                                if (r["nel"], r["s"], r["dtype"]) == (64, 4, "float32") and r["mode"].startswith(mode))
    return {"sw_pert": main(rows, "pert_"), "sw_halo": main(rows, "halo"), "sw_edges": main(rows, "edges"),
            "sw_run": main(runs, "run_pert")}


def phase18(torch):
    """GPU against CPU: the SW perturbation form through Tvdrk3, and
    packed_run, float64."""
    from wxfactory_tpu_torch.integrators import Tvdrk3
    from wxfactory_tpu_torch.kernels.check import sw_delta, sw_setup
    from wxfactory_tpu_torch.models import ShallowWaterRHS
    from wxfactory_tpu_torch.ops.sw_operator import tvdrk3_abc

    def scaled(got, want):
        scale = want.abs().reshape(3, -1).amax(dim=1).reshape(3, 1, 1, 1, 1)
        return float(((got - want).abs() / scale).max())

    results = []
    geom, ops, metric, topology, q0 = sw_setup(10, 3)
    states = {}
    for device in ("cuda", "cpu"):
        rhs = ShallowWaterRHS(geom, ops, metric, device=device, topology=topology, perturbation_base=q0)
        integ, q = Tvdrk3(rhs), torch.as_tensor(q0, device=device)
        for _ in range(10):
            q = integ.step(q, 30.0)
        states[device] = q.cpu()
    results.append({"run": "tvdrk3_perturbation", "nel": 10, "s": 3, "steps": 10, "dt": 30.0,
                    "err": scaled(states["cuda"], states["cpu"])})
    geom, ops, metric, topology, q0 = sw_setup(32, 4)
    for pert in (False, True):
        for device in ("cuda", "cpu"):
            rhs = ShallowWaterRHS(geom, ops, metric, device=device, topology=topology,
                                  perturbation_base=q0 if pert else None)
            q = torch.as_tensor(q0 + sw_delta(q0) if pert else q0, device=device)
            states[device] = rhs.unpack(rhs.packed_run(rhs.pack(q), 2, tvdrk3_abc(30.0))).cpu()
        results.append({"run": "packed_run_perturbation" if pert else "packed_run", "nel": 32, "s": 4, "steps": 2,
                        "dt": 30.0, "err": scaled(states["cuda"], states["cpu"])})
    ok = all(r["err"] <= 1e-10 for r in results)
    emit({"phase": 18, "dtype": "float64", "tol": 1e-10, "ok": ok, "results": results})
    if not ok:
        raise AssertionError(f"GPU and CPU SW runs differ: {results}")


# (nel, s, dt, steps, packed_run): bench.py:1021-1027's three SW operating points.
PRODUCTION = [(10, 3, 30.0, 200, False), (64, 3, 10.0, 100, False), (64, 4, 30.0, 100, True)]
GATE_REL = 5e-3  # bench.py:309
# Mass of a float32 state conserved to float32 round-off: its machine epsilon.
MASS_DRIFT_F32 = 2.0**-23

CASE6_F32_S4_INI = CASE6_INI.replace("precision = float64", "precision = float32").replace(
    "num_solpts = 3", "num_solpts = 4")


def _sw_gate(torch, nel, s, topology, geom, ops, metric, q0, rhs32):
    """bench.py:425-446: the f32 perturbation RHS against the f64 kernel
    truth at the initial state advanced four f64 TVD-RK3 steps of dt = 150
    (10/nel)(3/s), scaled by each variable's max tendency; the f32 absolute
    kernel's error beside it."""
    from wxfactory_tpu_torch.kernels.check import _scaled, per_variable_max
    from wxfactory_tpu_torch.models import ShallowWaterRHS

    rhs64 = ShallowWaterRHS(geom, ops, metric, device="cuda", topology=topology)
    dt = 150.0 * (10.0 / nel) * (3.0 / s)
    q = torch.as_tensor(q0, device="cuda")
    for _ in range(4):
        k1 = q + dt * rhs64(q)
        k2 = 0.75 * q + 0.25 * (k1 + dt * rhs64(k1))
        q = q / 3.0 + 2.0 / 3.0 * (k2 + dt * rhs64(k2))
    truth = rhs64(q)
    scale = per_variable_max(truth)
    err = _scaled(rhs32.delta((q - rhs32.base_state.double()).float()).double() - truth, scale)
    abs32 = ShallowWaterRHS(geom, ops, metric, dtype=torch.float32, device="cuda", topology=topology)
    return err, _scaled(abs32(q.float()).double() - truth, scale)


def _sw_production(torch, nel, s, dt, nsteps, packed):
    """One SW operating point: f32 perturbation form around case 6's
    initial state, ``nsteps`` chained TVD-RK3 steps (and, with ``packed``,
    the same steps in one packed_run launch)."""
    from wxfactory_tpu_torch.integrators import Tvdrk3
    from wxfactory_tpu_torch.kernels.check import sw_setup
    from wxfactory_tpu_torch.models import ShallowWaterRHS
    from wxfactory_tpu_torch.ops.sw_operator import tvdrk3_abc
    from wxfactory_tpu_torch.output.diagnostics import global_integral_2d
    from wxfactory_tpu_torch.profile import profile_calls

    geom, ops, metric, topology, q0 = sw_setup(nel, s)
    reset_counts()
    t0 = time.perf_counter()
    rhs = ShallowWaterRHS(geom, ops, metric, dtype=torch.float32, device="cuda", topology=topology,
                          perturbation_base=q0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # The perturbation base: the edge-trace and halo kernels once, and the
    # float64 base RHS (the operator fed that halo).
    counts = read_counts()
    setup_want = {"sw_edges": 1, "sw_halo": 1, "sw_operator": 1, "sw_state": 0, "sw_pert": 0, "sw_plain_calls": 0}
    setup_launches = {k: counts[k] for k in setup_want}
    if setup_launches != setup_want:
        raise AssertionError(f"setup at ({nel},{s}): launches {setup_launches}, expected {setup_want}")
    gate, gate_abs = _sw_gate(torch, nel, s, topology, geom, ops, metric, q0, rhs)
    if not gate < GATE_REL:
        raise AssertionError(f"f32 perturbation RHS {gate} of the tendency scale from the f64 truth at "
                             f"({nel},{s}), gate {GATE_REL}")
    q_init = torch.as_tensor(q0, dtype=torch.float32, device="cuda")
    mass = lambda q: global_integral_2d(q[0].double().cpu().numpy(), ops, metric)
    mass0 = mass(q_init)
    points = 6 * nel * nel * s * s

    def chained():
        integ, q = Tvdrk3(rhs), q_init
        for _ in range(nsteps):
            q = integ.step(q, dt)
        return q, integ

    def check_state(q, what):
        if not bool(torch.isfinite(q).all()):
            raise AssertionError(f"{what} at ({nel},{s}) is not finite")
        drift = (mass(q) - mass0) / mass0
        if not abs(drift) < MASS_DRIFT_F32:
            raise AssertionError(f"{what} at ({nel},{s}): mass drift {drift}, limit {MASS_DRIFT_F32}")
        return drift

    def busy(fn, run_s):
        """The card's busy share of ``fn`` from a torch.profiler trace
        (None where the trace holds no device event), and its device span
        share: the same calls queued behind a sleep kernel, which also
        counts the card's gaps between dependent launches."""
        prof = profile_calls(fn)
        share = prof["device_busy_share"] if prof["device_ops"] > 0 else None
        return share, _device_ms(torch, fn, 1) * 1e-3 / run_s, prof

    Tvdrk3(rhs).step(q_init, dt)  # first launches (library load) outside the timed run
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    q, integ = chained()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    want = {"sw_pert": 3 * nsteps, "sw_state": 3 * nsteps, "sw_halo": 0, "sw_edges": 0, "sw_operator": 0,
            "sw_run": 0, "sw_plain_calls": 0}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"chained run at ({nel},{s}): launches {got}, expected {want}")
    row = {"case": 6, "nel": nel, "s": s, "points": points, "dtype": "float32", "form": "perturbation",
           "integrator": "tvdrk3", "dt": dt, "steps": nsteps, "setup_s": setup_s, "chained_s": elapsed,
           "chained_gridpoints_per_s": points * 3 * nsteps / elapsed, "chained_steps_per_s": nsteps / elapsed,
           "setup_launches": setup_launches, "chained_launches": got,
           "chained_mass_drift": check_state(q, "chained state"),
           "gate_err": gate, "gate_err_f32_absolute": gate_abs, "gate": GATE_REL}
    row["chained_device_busy_share"], row["chained_device_span_share"], prof = busy(chained, elapsed)
    row["chained_device_ops_per_step"] = prof["device_ops"] / nsteps
    row["chained_kernels_us"] = prof["kernels_us"][:4]
    launches = dict(got, sw_halo=setup_launches["sw_halo"], sw_edges=setup_launches["sw_edges"])
    if packed:
        abc = tvdrk3_abc(dt)
        qp = rhs.pack(q_init)
        rhs.packed_run(qp, 1, abc)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = rhs.packed_run(qp, nsteps, abc)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = read_counts()
        want = {"sw_run": 1, "sw_pert": 0, "sw_halo": 0, "sw_edges": 0, "sw_operator": 0, "sw_plain_calls": 0}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"packed_run at ({nel},{s}): launches {got}, expected {want}")
        launches["sw_run"] = 1
        chain_out = integ._cache[1]
        if not torch.equal(out, chain_out):
            raise AssertionError(f"packed_run at ({nel},{s}) differs from the chained kernels by up to "
                                 f"{float((out - chain_out).abs().max())}; the two are bit for bit equal")
        share, span, _ = busy(lambda: rhs.packed_run(qp, nsteps, abc), elapsed)
        row.update({
            "packed_run_s": elapsed, "packed_run_gridpoints_per_s": points * 3 * nsteps / elapsed,
            "packed_run_steps_per_s": nsteps / elapsed, "packed_run_launches": got,
            "packed_run_mass_drift": check_state(rhs.unpack(out), "packed_run state"),
            "packed_run_bit_identical_to_chain": True,
            "packed_run_device_busy_share": share, "packed_run_device_span_share": span,
        })
    return row, launches


def phase19(torch):
    from wxfactory_tpu_torch import __main__ as cli

    # totals: the chained runs' launches, and the edge-trace and halo launches
    # of their setup (the perturbation base), which no step makes
    rows, totals = [], {}
    for point in PRODUCTION:
        row, launches = _sw_production(torch, *point)
        rows.append(row)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    # The port's Simulation at float32, s=4 (absolute form, as the JAX
    # Simulation runs it): the operator's state mode alone.
    nsteps, nel = 50, 32
    out_dir = WORK / "phase19_sim"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    ini = WORK / "case6_f32_s4_nel32.ini"
    ini.write_text(CASE6_F32_S4_INI.format(dt=30, t_end=30 * nsteps, nel=nel, save=nsteps, out=out_dir))
    log = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(ini), "--device", "cuda"])
    counts = read_counts()
    text = log.getvalue()
    want = {"sw_operator": 3 * nsteps, "sw_state": 3 * nsteps, "sw_halo": 0, "sw_edges": 0, "sw_pert": 0,
            "sw_run": 0, "sw_plain_calls": 0}
    got = {k: counts[k] for k in want}
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    drifts = [float(v) for v in re.findall(r"normalized error for mass = (\S+)", text)]
    if rc != 0 or run is None or got != want:
        raise AssertionError(f"f32 s=4 CLI run exited with {rc}, launches {got}, expected {want}")
    sim = {"case": 6, "nel": nel, "s": 4, "dtype": "float32", "form": "absolute", "integrator": "tvdrk3",
           "dt": 30.0, "steps": int(run.group(1)), "steps_per_s": float(run.group(3)), "launches": got,
           "mass_drift": drifts[-1] if drifts else None}
    for k in ("sw_halo", "sw_edges", "sw_state"):
        totals[k] = totals.get(k, 0) + got[k]
    emit({"phase": 19, "results": rows, "simulation": sim, "launches_total": totals})
    return totals


def _bound(work, dtype_name):
    """The least time (ms) of a call that moves ``work`` = (bytes,
    operations): the larger of the bytes over the card's memory rate and the
    operations over its peak rate for the type."""
    nbytes, ops = work
    b = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": ops / PEAK_FLOPS[dtype_name] * 1e3}
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(b.values()), "bound_by": max(b, key=b.get)}


def _device_ms(torch, fn, n):
    """The card's time a call of ``fn``: ``n`` calls queued behind a sleep
    kernel that outlasts the host's enqueueing of them, timed by two CUDA
    events, so the host's time between launches does not count (a single
    call between two events measures the host for kernels this short)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 2_000_000)  # cycles: twice the host time at up to 2 GHz
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _pair_ms(torch, kernel, plain, n=10, n_plain=5):
    """A kernel call and its plain version: the card's time a call
    (``_device_ms``) and the median time of single calls between two CUDA
    events, in turns (plain, kernel, kernel, plain), which includes what the
    host adds between the events."""
    for fn in (kernel, plain):
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    k, p = [], []
    for fn, times, count in ((plain, p, n_plain), (kernel, k, n), (kernel, k, n), (plain, p, n_plain)):
        times.extend(_event_times(torch, fn, n=count))
    return {"kernel_ms": _device_ms(torch, kernel, n), "plain_ms": _device_ms(torch, plain, n_plain),
            "kernel_event_ms": statistics.median(k), "plain_event_ms": statistics.median(p)}


RUN_STEPS = 20
# Phase 20's bit-for-bit check of the state mode: the timed shapes and the
# other values of s.
STATE_SHAPES = [(64, 3), (64, 4), (64, 7), (4, 2), (3, 5), (2, 6), (4, 8)]


def phase20(torch, smi):
    from wxfactory_tpu_torch.kernels import check
    from wxfactory_tpu_torch.ops import sw_operator as swop

    # The state mode bit for bit the three launches it replaces.
    state_rows = [r for nel, s in STATE_SHAPES for dtype in (torch.float64, torch.float32)
                  for r in check.compare_sw_state_halo(nel, s, dtype, device="cuda")]
    emit_comparison(20, state_rows, ("nel", "s"), tag="_state")
    bad = [r for r in state_rows if not r["ok"]]
    if bad:
        raise AssertionError(f"the state mode differs from the edge-trace, halo and operator kernels: {bad}")

    rows = []
    for nel, s in ((64, 3), (64, 4), (64, 7)):
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).replace("torch.", "")
            con, topology, base, dq, x = check.sw_pert_inputs(nel, s, dtype, "cuda")
            traces = swop.sw_edges(dq, con)
            halo = swop.sw_halo(traces, topology)
            qa = (base.q0 + dq).contiguous()
            halo_a = swop.sw_halo(swop.sw_edges(qa, con), topology)
            stage = dict(x=x, a=0.75, b=0.25, cdt=7.5, emit_traces=True)
            stage_x = dict(x=x, a=0.75, b=0.25, cdt=7.5)
            row = {"nel": nel, "s": s, "dtype": name}
            row["state_rhs_max_abs_err"] = float((swop.sw_operator(qa, None, con, topology=topology)
                                                  - swop.sw_operator_plain(qa, None, con, topology=topology))
                                                 .abs().max())
            row["state_pert_stage_x_max_abs_err"] = float(
                (swop.sw_operator(dq, None, con, base=base, topology=topology, **stage_x)
                 - swop.sw_operator_pert_plain(dq, None, con, base, topology=topology, **stage_x)).abs().max())
            pairs = {
                "rhs": (lambda: swop.sw_operator(qa, halo_a, con), lambda: swop.sw_operator_plain(qa, halo_a, con),
                        check.sw_work(nel, s, dtype)),
                "pert_rhs": (lambda: swop.sw_operator(dq, halo, con, base=base),
                             lambda: swop.sw_operator_pert_plain(dq, halo, con, base),
                             check.sw_pert_work(nel, s, dtype)),
                "pert_stage_traces": (lambda: swop.sw_operator(dq, halo, con, base=base, **stage),
                                      lambda: swop.sw_operator_pert_plain(dq, halo, con, base, **stage),
                                      check.sw_pert_work(nel, s, dtype, stage=True, use_x=True, traces=True)),
                "state_rhs": (lambda: swop.sw_operator(qa, None, con, topology=topology),
                              lambda: swop.sw_operator_plain(qa, None, con, topology=topology),
                              check.sw_work(nel, s, dtype, state=True)),
                "state_pert_stage_x": (lambda: swop.sw_operator(dq, None, con, base=base, topology=topology, **stage_x),
                                       lambda: swop.sw_operator_pert_plain(dq, None, con, base, topology=topology,
                                                                           **stage_x),
                                       check.sw_pert_work(nel, s, dtype, stage=True, use_x=True, state=True)),
                "halo": (lambda: swop.sw_halo(traces, topology), lambda: swop.halo_from_traces(traces, topology),
                         check.sw_halo_work(nel, s, dtype)),
                "edges": (lambda: swop.sw_edges(dq, con), lambda: swop.edge_traces(dq, con),
                          check.sw_edges_work(nel, s, dtype)),
            }
            if s == 4:
                abc = swop.tvdrk3_abc(30.0)
                pairs[f"run_{RUN_STEPS}_steps"] = (
                    lambda: swop.sw_run(dq, RUN_STEPS, abc, con, topology, base=base),
                    lambda: swop.sw_run_plain(dq, RUN_STEPS, abc, con, topology, base=base),
                    check.sw_run_work(nel, s, dtype, RUN_STEPS, pert=True))

                def chained_step():
                    return swop.sw_chain(dq, 1, abc, con, topology, base=base)

                for _ in range(3):
                    chained_step()
                row["chained_step_event_ms"] = statistics.median(_event_times(torch, chained_step, n=20))
                row["chained_step_ms"] = _device_ms(torch, chained_step, 10)
            for mode, (kernel, plain, work) in pairs.items():
                slow = mode.startswith("run")
                times = _pair_ms(torch, kernel, plain, n=5 if slow else 10, n_plain=2 if slow else 5)
                row.update({f"{mode}_{key}": v for key, v in times.items()})
                row.update({f"{mode}_{key}": v for key, v in _bound(work, name).items()})
            # The state mode in turns with the three launches it replaces (the
            # edge-trace and halo kernels, then the operator fed their halo).
            route = {
                "state_rhs": (lambda: swop.sw_operator(qa, None, con, topology=topology),
                              lambda: swop.sw_operator(qa, swop.sw_halo(swop.sw_edges(qa, con), topology), con)),
                "state_pert_stage_x": (
                    lambda: swop.sw_operator(dq, None, con, base=base, topology=topology, **stage_x),
                    lambda: swop.sw_operator(dq, swop.sw_halo(swop.sw_edges(dq, con), topology), con, base=base,
                                             **stage_x)),
            }
            for mode, (one, three) in route.items():
                turns = {"one": [], "three": []}
                for key, fn in (("three", three), ("one", one), ("one", one), ("three", three)):
                    turns[key].append(_device_ms(torch, fn, 10))
                row[f"{mode}_in_turns_ms"] = turns["one"]
                row[f"{mode}_three_launches_in_turns_ms"] = turns["three"]
            if s == 4:
                row["run_ms_per_step"] = row[f"run_{RUN_STEPS}_steps_kernel_ms"] / RUN_STEPS
                row["run_event_ms_per_step"] = row[f"run_{RUN_STEPS}_steps_kernel_event_ms"] / RUN_STEPS
            rows.append(row)
    resources = {f"{str(dtype).replace('torch.', '')} s={s}": check.sw_kernel_resources(dtype, s)
                 for dtype in (torch.float64, torch.float32) for s in range(2, 9)}
    emit({"phase": 20, "gpu": smi, "timing": "*_ms: the card's time a call (calls queued behind a sleep kernel, "
          "CUDA events); *_event_ms: CUDA events around single calls, median", "results": rows,
          "resources": resources, "state_bit_identical": sum(r["bit_identical"] for r in state_rows),
          "state_cases": len(state_rows)})
    main = lambda nel, s, dtype: next(r for r in rows if (r["nel"], r["s"], r["dtype"]) == (nel, s, dtype))
    # The main paths' shapes: phase 3's absolute RHS at (64,3) f64 and phase
    # 19's perturbation stages at (64,4) f32.
    return {"sw_operator": main(64, 3, "float64"), "sw_pert": main(64, 4, "float32")}


def phase21(torch):
    """The perturbation mode's stage kernel (stage combination of deltas and
    the output's delta traces) against its plain version."""
    from wxfactory_tpu_torch.kernels.check import compare_euler3d_pert_stage

    rows = []
    for nel_h, nel_v, s, case in E3_SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows += compare_euler3d_pert_stage(nel_h, nel_v, s, dtype, device="cuda", case=case)
    emit_comparison(21, rows, ("nel_h", "nel_v", "s", "case"))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"perturbation stage kernel disagrees with its plain version: {bad}")
    main_path = [r for r in rows if (r["nel_h"], r["nel_v"], r["s"], r["dtype"]) == E3_MAIN + ("float32",)]
    return max(r["max_abs_err"] for r in main_path)


# (nel_h, nel_v, s, dt, steps): bench.py:623-685's canonical dcmip31 point and
# phase 7's constant-DOF shape.
E3_PRODUCTION = [(12, 3, 2, 0.5, 75), E3_MAIN + (0.1, 100)]


def _e3_gate(torch, geom, ops, metric, topology, q0, rhs32, bal32):
    """bench.py:640-656: four float64 TVD-RK3 steps of dt = 0.5 s from q0,
    then the float32 RHS there against the float64 RHS, per variable's
    tendency scale: the perturbation form's error and the f32 bal form's."""
    from wxfactory_tpu_torch.kernels.check import _scaled, per_variable_max
    from wxfactory_tpu_torch.models import Euler3DRHS

    rhs64 = Euler3DRHS(geom, ops, metric, device="cuda", topology=topology)
    q = torch.as_tensor(q0, device="cuda")
    for _ in range(4):
        k1 = q + 0.5 * rhs64(q)
        k2 = 0.75 * q + 0.25 * (k1 + 0.5 * rhs64(k1))
        q = q / 3.0 + 2.0 / 3.0 * (k2 + 0.5 * rhs64(k2))
    truth = rhs64(q)
    scale = per_variable_max(truth)
    return _scaled(rhs32(q.float()).double() - truth, scale), _scaled(bal32(q.float()).double() - truth, scale)


def _e3_production(torch, nel_h, nel_v, s, dt, nsteps):
    """The dcmip31 explicit point at one shape: float32 perturbation form
    around the initial state stepped by Tvdrk3 (one perturbation stage
    launch a stage), beside the float32 form with the well-balanced offset
    and the float64 absolute form; launches, gate, state, mass and rates."""
    from wxfactory_tpu_torch.integrators import Tvdrk3
    from wxfactory_tpu_torch.kernels.check import euler3d_setup
    from wxfactory_tpu_torch.models import Euler3DRHS
    from wxfactory_tpu_torch.output import global_mass_3d
    from wxfactory_tpu_torch.profile import profile_calls

    geom, ops, metric, topology, q0 = euler3d_setup(nel_h, nel_v, s, 31)
    t0 = time.perf_counter()
    pert = Euler3DRHS(geom, ops, metric, dtype=torch.float32, device="cuda", topology=topology, perturbation_base=q0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    forms = {
        "f32_perturbation": pert,
        "f32_bal": Euler3DRHS(geom, ops, metric, dtype=torch.float32, device="cuda", topology=topology,
                              base_state=q0),
        "f64_absolute": Euler3DRHS(geom, ops, metric, device="cuda", topology=topology),
    }
    gate, gate_bal = _e3_gate(torch, geom, ops, metric, topology, q0, pert, forms["f32_bal"])
    if not gate < GATE_REL:
        raise AssertionError(f"f32 perturbation RHS {gate} of the tendency scale from the f64 truth at "
                             f"{nel_h}x{nel_v}x{s}, gate {GATE_REL}")
    points = 6 * nel_v * nel_h * nel_h * s**3
    mass = lambda q: global_mass_3d(q.double().cpu().numpy(), ops, metric)
    mass0 = mass(torch.as_tensor(q0))
    row = {"case": 31, "nel_h": nel_h, "nel_v": nel_v, "s": s, "points": points, "integrator": "tvdrk3", "dt": dt,
           "steps": nsteps, "setup_s_perturbation": setup_s, "gate_err": gate, "gate_err_f32_bal": gate_bal,
           "gate": GATE_REL}
    launches = {}
    for name, rhs in forms.items():
        dtype = rhs.dtype
        q_init = torch.as_tensor(q0, dtype=dtype, device="cuda")

        def chained():
            integ, q = Tvdrk3(rhs), q_init
            for _ in range(nsteps):
                q = integ.step(q, dt)
            return q, integ

        Tvdrk3(rhs).step(q_init, dt)  # first launches (library load) outside the timed run
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        q, integ = chained()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = read_counts()
        pert_form = name == "f32_perturbation"
        want = {"euler3d_pert_stage": 3 * nsteps if pert_form else 0, "euler3d_pert": 0,
                "euler3d_operator": 0 if pert_form else 3 * nsteps, "euler3d_plain_calls": 0}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"{name} at {nel_h}x{nel_v}x{s}: launches {got}, expected {want}")
        if not bool(torch.isfinite(q).all()):
            raise AssertionError(f"{name} at {nel_h}x{nel_v}x{s} is not finite")
        # The perturbation form's mass: q0 + its carried delta in float64.
        qm = torch.as_tensor(q0, device="cuda") + integ._cache[1].double() if pert_form else q
        drift = (mass(qm) - mass0) / mass0
        limit = {"f32_perturbation": MASS_DRIFT_F32, "f64_absolute": 1e-11}.get(name)
        if limit is not None and not abs(drift) < limit:
            raise AssertionError(f"{name} at {nel_h}x{nel_v}x{s}: mass drift {drift}, limit {limit}")
        prof = profile_calls(chained)
        launches[name] = got
        row.update({
            f"{name}_s": elapsed, f"{name}_gridpoints_per_s": points * 3 * nsteps / elapsed,
            f"{name}_steps_per_s": nsteps / elapsed, f"{name}_launches": got, f"{name}_mass_drift": drift,
            f"{name}_device_busy_share": prof["device_busy_share"] if prof["device_ops"] > 0 else None,
            f"{name}_device_span_share": _device_ms(torch, chained, 1) * 1e-3 / elapsed,
            f"{name}_device_ops_per_step": prof["device_ops"] / nsteps, f"{name}_kernels_us": prof["kernels_us"][:3],
        })
    return row, launches["f32_perturbation"]["euler3d_pert_stage"]


def phase22(torch):
    rows, stage_launches = [], 0
    for point in E3_PRODUCTION:
        row, n = _e3_production(torch, *point)
        rows.append(row)
        stage_launches += n
    emit({"phase": 22, "results": rows, "pert_stage_launches": stage_launches})
    return stage_launches


ROS2_LINE = re.compile(r"FGMRES\(jit\) convergence at iteration (\d+), relative residual (\S+), (\d+) cycles, "
                       r"(\d+) masked, (\d+) matvecs")
ROS2_CHUNK = re.compile(r"FGMRES\(jit\) chunk of (\d+): (\d+) total iterations, last relative residual (\S+), "
                        r"(\d+) cycles, (\d+) masked, (\d+) matvecs")
ROS2_HOST = re.compile(r"fgmres convergence at iteration (\d+) in (\S+) s, relative residual (\S+)")


def ros2_ini(solver: str, mixed: int, chunk: int, **kw) -> str:
    return DCMIP31_INI.format(integrator="ros2", **kw).replace(
        "exponential_solver = kiops",
        f"linear_solver = {solver}\nmixed_precision_krylov = {mixed}\ndevice_step_chunk = {chunk}")


def _ros2_run(torch, nel_h, nel_v, s, dt, nsteps, solver, mixed, chunk, tag):
    """One dcmip31 Ros2 run (tolerance 1e-7, gmres_restart at its default)
    through ``Simulation(ini).run()``, the CLI's own call, on
    the card; the device solver under ``forbid_uncounted_syncs``. Checks
    launches against Jacobian actions, syncs, state and mass at the
    checkpoints; returns its JSON row."""
    from wxfactory_tpu_torch.common.device import forbid_uncounted_syncs
    from wxfactory_tpu_torch.output import global_mass_3d
    from wxfactory_tpu_torch.output.state import load_state
    from wxfactory_tpu_torch.simulation import Simulation

    out_dir = WORK / f"phase23_{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    ini = WORK / f"dcmip31_ros2_{tag}.ini"
    save = min(chunk, nsteps)  # a checkpoint at every chunk's end
    ini.write_text(ros2_ini(solver, mixed, chunk, dt=dt, t_end=dt * nsteps, s=s, nel_h=nel_h, nel_v=nel_v,
                            save=save, out=out_dir, verbose=1))
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        sim = Simulation(str(ini), device="cuda")
        with forbid_uncounted_syncs() if solver != "fgmres" else contextlib.nullcontext():
            sim.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = log.getvalue()
    sys.stderr.write(text[-2000:])
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    if run is None:
        raise AssertionError(f"Ros2 run {tag} did not complete")
    if "WARNING" in text:
        raise AssertionError(f"Ros2 run {tag} printed a warning")
    if solver == "fgmres":
        lines = [(int(m.group(1)), 0, 0) for m in ROS2_HOST.finditer(text)]
        nsolves = len(lines)
    elif chunk > 1:
        lines = [(int(m.group(2)), int(m.group(4)), int(m.group(5))) for m in ROS2_CHUNK.finditer(text)]
        nsolves = sum(int(m.group(1)) for m in ROS2_CHUNK.finditer(text))
    else:
        lines = [(int(m.group(1)), int(m.group(3)), int(m.group(4))) for m in ROS2_LINE.finditer(text)]
        nsolves = len(lines)
    iterations, cycles = sum(l[0] for l in lines), sum(l[1] for l in lines)
    if nsolves != nsteps:
        raise AssertionError(f"Ros2 run {tag}: {nsolves} solves reported for {nsteps} steps")
    # One float64 RHS a step (and, mixed, the companion's float64 base RHS at
    # setup); every Jacobian action is one tangent-kernel launch.
    tangents = counts["euler3d_tangent"] + counts["euler3d_pert_tangent"]
    if counts["euler3d_operator"] != nsteps + mixed:
        raise AssertionError(f"{counts['euler3d_operator']} RHS-kernel launches in {nsteps} Ros2 steps")
    if tangents != counts["jacobian_actions"] or tangents == 0 or counts["plain_tangent_calls"]:
        raise AssertionError(f"Ros2 run {tag}: tangent launches {tangents} against Jacobian actions "
                             f"{counts['jacobian_actions']}, plain tangent calls {counts['plain_tangent_calls']}")
    if bool(counts["euler3d_pert_tangent"]) != bool(mixed):
        raise AssertionError(f"Ros2 run {tag}: perturbation tangent launches {counts['euler3d_pert_tangent']}")
    # Linearisation points: the float64 RHS's a step, and the companion's (mixed).
    if counts["euler3d_tangent_prep"] != nsteps * (1 + mixed) or counts["euler3d_plain_calls"]:
        raise AssertionError(f"Ros2 run {tag}: {counts['euler3d_tangent_prep']} tangent prep launches in {nsteps} "
                             f"steps, plain calls {counts['euler3d_plain_calls']}")
    # Counted waits of the device solver: |r0| and |b| and one read a cycle
    # a solve, the NaN guard and a checkpoint a chunk, the initial
    # checkpoint and the final synchronize; no other wait can have happened.
    step_syncs = counts["host_syncs"] - 2
    if solver != "fgmres" and step_syncs > cycles + nsteps + 2 * -(-nsteps // save):
        raise AssertionError(f"{step_syncs} host syncs for {cycles} cycles in {nsteps} steps")
    ops, metric = sim.ops, sim.metric
    masses = {}
    for step in range(0, nsteps + 1, save):
        files = glob.glob(str(out_dir / f"state_vector_*.{step:08d}.npy"))
        if len(files) != 1:
            raise AssertionError(f"checkpoint files {files}")
        q, _, _ = load_state(files[0])
        masses[step] = global_mass_3d(q, ops, metric)
    if not bool(torch.isfinite(torch.as_tensor(q)).all()):
        raise AssertionError(f"Ros2 run {tag}: state not finite")
    drifts = {k: (m - masses[0]) / masses[0] for k, m in masses.items() if k}
    if not max(abs(d) for d in drifts.values()) < 1e-7:
        raise AssertionError(f"Ros2 run {tag}: mass drift {drifts}")
    run_s = float(run.group(2))
    return {
        "case": 31, "nel_h": nel_h, "nel_v": nel_v, "s": s, "points": 6 * nel_v * nel_h * nel_h * s**3,
        "integrator": "ros2", "linear_solver": solver, "mixed_precision_krylov": mixed, "device_step_chunk": chunk,
        "gmres_restart": sim.integrator.gmres_restart, "tolerance": 1e-7, "dt": dt, "steps": int(run.group(1)),
        "setup_s": wall - run_s, "run_s": run_s, "steps_per_s": float(run.group(3)),
        "iterations": iterations, "iterations_per_step": iterations / nsteps, "cycles": cycles,
        "masked_iterations": sum(l[2] for l in lines), "rhs_launches": counts["euler3d_operator"],
        "tangent_launches": counts["euler3d_tangent"], "pert_tangent_launches": counts["euler3d_pert_tangent"],
        "tangent_prep_launches": counts["euler3d_tangent_prep"],
        "jacobian_actions": counts["jacobian_actions"], "host_syncs": counts["host_syncs"],
        "host_syncs_per_step": step_syncs / nsteps, "mass_drift_per_checkpoint": drifts,
    }


def _ros2_gate(torch):
    """tests/test_euler3d.py:293-318 on the card: two mixed-precision steps
    against two float64 fgmres_jit steps at the canonical shape, 5e-5 of
    each variable's max and 2e-3 on rho*w."""
    from wxfactory_tpu_torch.config import Configuration
    from wxfactory_tpu_torch.simulation import Simulation

    states = {}
    for mixed in (0, 1):
        text = ros2_ini("fgmres_jit", mixed, 1, dt=30, t_end=60, s=2, nel_h=12, nel_v=3, save=0,
                        out=WORK / "phase23_gate", verbose=0)
        with contextlib.redirect_stdout(io.StringIO()):
            states[mixed] = Simulation(Configuration(text), device="cuda").run().cpu()
    scale = states[0].abs().reshape(5, -1).amax(dim=1)
    err = ((states[1] - states[0]).abs().reshape(5, -1).amax(dim=1) / scale).tolist()
    ok = max(err[i] for i in (0, 1, 2, 4)) < 5e-5 and err[3] < 2e-3
    return {"err_per_variable": err, "limits": [5e-5, 5e-5, 5e-5, 2e-3, 5e-5], "ok": ok}


# (nel_h, nel_v, s, dt, steps, tag): the canonical dcmip31 Ros2 point, and
# phase 7's shape at dt = 2 s: there, at dt = 30 s, FGMRES(20) without a
# preconditioner stalls (relative residual 1.2e-5 after 20,000 iterations;
# 1.1e-6 after 1,200 at dt = 3 s, converged in 55 at dt = 2 s on an H100:
# tools/ros2_fgmres_dt.py).
ROS2_POINTS = [(12, 3, 2, 30.0, 5, "canonical"), E3_KRYLOV_MAIN + (2.0, 3, "main")]


def phase23(torch):
    rows = []
    for nel_h, nel_v, s, dt, nsteps, tag in ROS2_POINTS:
        for solver, mixed, chunk in (("fgmres", 0, 1), ("fgmres_jit", 0, 5), ("fgmres_jit", 1, 5)):
            rows.append(_ros2_run(torch, nel_h, nel_v, s, dt, nsteps, solver, mixed, chunk,
                                  f"{tag}_{solver}{'_mixed' if mixed else ''}"))
    gate = _ros2_gate(torch)
    emit({"phase": 23, "results": rows, "mixed_vs_float64_after_2_steps": gate})
    if not gate["ok"]:
        raise AssertionError(f"mixed Ros2 against float64: {gate}")


def _fgmres_cycle(torch, A, b, x0, basis_dtype, A32, restart=20):
    """One restart cycle of fgmres_jit (tolerance 0: no iteration converges)
    between CUDA events and under torch.profiler: milliseconds an inner
    iteration, and the device time of an iteration by class."""
    from wxfactory_tpu_torch.profile import profile_calls
    from wxfactory_tpu_torch.solvers.fgmres_jit import fgmres_jit

    run = lambda: fgmres_jit(A, b, x0=x0, tol=0.0, restart=restart, max_outer=1, A32=A32, basis_dtype=basis_dtype)
    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _, info = run()
    end.record()
    end.synchronize()
    prof = profile_calls(run)
    per_it = {k: v / restart for k, v in prof["classes_us"].items()}
    return {"event_ms_per_iteration": start.elapsed_time(end) / restart, "device_us_per_iteration": per_it,
            "device_ops_per_iteration": prof["device_ops"] / restart, "iterations": info.num_iter}


def phase24(torch, smi):
    """Timing at 20x20x20, s=3: the perturbation stage kernel (stage + x +
    delta traces) against its plain version and its bound, f32 and f64;
    an FGMRES inner iteration of Ros2 (dt = 30 s) split into basis
    products, tangent kernel and the rest, float64 and mixed."""
    from wxfactory_tpu_torch.kernels.check import E3_DT, euler3d_pert_inputs, euler3d_pert_work, euler3d_setup
    from wxfactory_tpu_torch.models import Euler3DRHS
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op
    from wxfactory_tpu_torch.solvers.matvec import companion_jacobian, make_rat_matvec

    rows = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        con, topology, pert, dq, _ = euler3d_pert_inputs(*E3_MAIN, dtype, "cuda")
        halo = e3op.halo_from_traces(e3op.edge_traces_delta(dq, pert, con), topology)
        x = dq.flip(0).contiguous()
        stage = dict(x=x, a=0.75, b=0.25, cdt=0.25 * E3_DT, emit_traces=True)
        times = _pair_ms(torch, lambda: e3op.euler3d_operator(dq, halo, con, pert=pert, **stage),
                         lambda: e3op.euler3d_operator_pert_plain(dq, halo, con, pert, **stage), n=10, n_plain=3)
        nbytes, ops = euler3d_pert_work(con, stage=True, use_x=True, traces=True)
        bound = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": ops / PEAK_FLOPS[name] * 1e3}
        rows.append(dict({"nel_h": E3_MAIN[0], "nel_v": E3_MAIN[1], "s": E3_MAIN[2], "dtype": name,
                          "mode": "pert_stage_x_traces", "bytes": nbytes, "ops": ops,
                          "bound_ms": max(bound.values()), "bound_by": max(bound, key=bound.get),
                          "pert_rhs_ms": _device_ms(torch, lambda: e3op.euler3d_operator(dq, halo, con, pert=pert),
                                                    10)},
                         **times))
    geom, ops, metric, topology, q0 = euler3d_setup(*E3_MAIN, 31)
    rhs = Euler3DRHS(geom, ops, metric, device="cuda", topology=topology)
    rhs32 = Euler3DRHS(geom, ops, metric, dtype=torch.float32, device="cuda", topology=topology, perturbation_base=q0)
    q = torch.as_tensor(q0, device="cuda")
    A = make_rat_matvec(rhs, q, 30.0)
    qv = q.reshape(-1)
    b = A(qv) + rhs(q).reshape(-1) * 30.0
    q32 = q.float()
    A32 = make_rat_matvec(rhs32, q32, 30.0, jac=companion_jacobian(rhs32, q32))
    iteration = {"float64": _fgmres_cycle(torch, A, b, qv, None, None),
                 "mixed": _fgmres_cycle(torch, A, b, qv, torch.float32, A32)}
    emit({"phase": 24, "gpu": smi, "timing": "*_ms: the card's time a call (calls queued behind a sleep kernel, "
          "CUDA events); *_event_ms: CUDA events around single calls, median; fgmres: one 20-iteration cycle",
          "results": rows, "fgmres_iteration": iteration})
    return next(r for r in rows if r["dtype"] == "float32")


def phase25(torch):
    """The tile kernels against their plain versions."""
    from wxfactory_tpu_torch.kernels.check import E3_TILE_SHAPES, SW_TILE_SHAPES, compare_euler3d_tile, compare_sw_tile

    sw_rows, e3_rows = [], []
    for nt, s, n in SW_TILE_SHAPES:
        for dtype in (torch.float64, torch.float32):
            sw_rows += compare_sw_tile(nt, s, n, dtype, device="cuda")
    for shape in E3_TILE_SHAPES:
        for dtype in (torch.float64, torch.float32):
            e3_rows += compare_euler3d_tile(*shape, dtype, device="cuda")
    emit_comparison(25, sw_rows, ("nt", "s", "n"), "_sw")
    emit_comparison(25, e3_rows, ("nt", "nk", "s", "case", "n"), "_euler3d")
    bad = [r for r in sw_rows + e3_rows if not r["ok"]]
    if bad:
        raise AssertionError(f"tile kernel disagrees with its plain version: {bad}")
    # The main path's tiles: N = 2 of phase 26's shapes, float64.
    sw_main = (SW_TILE_MAIN[0] // 2, SW_TILE_MAIN[1], 2, "float64")
    e3_main = (E3_MAIN[0] // 2, E3_MAIN[1], E3_MAIN[2], 2, "float64")
    return {"sw_tile": max(r["max_abs_err"] for r in sw_rows if (r["nt"], r["s"], r["n"], r["dtype"]) == sw_main),
            "euler3d_tile": max(r["max_abs_err"] for r in e3_rows
                                if (r["nt"], r["nk"], r["s"], r["n"], r["dtype"]) == e3_main)}


def _tile_run(torch, model, n, dtype, pert):
    """One tile-parallel run on the card with every tile in this process:
    TILE_STEPS steps of the tile step, its launches, state, mass and rates,
    and the port's global chain of the same form beside it."""
    from wxfactory_tpu_torch.integrators import Tvdrk3
    from wxfactory_tpu_torch.kernels.check import euler3d_setup, per_variable_max, sw_setup
    from wxfactory_tpu_torch.models import Euler3DRHS, ShallowWaterRHS
    from wxfactory_tpu_torch.output import global_mass_3d
    from wxfactory_tpu_torch.output.diagnostics import global_integral_2d
    from wxfactory_tpu_torch.parallel import TileMesh
    from wxfactory_tpu_torch.parallel.mesh import tile_view
    from wxfactory_tpu_torch.parallel.shard_map_euler3d_fused import make_shard_map_euler3d_step_fused
    from wxfactory_tpu_torch.parallel.shard_map_sw_fused import make_shard_map_sw_step_fused
    from wxfactory_tpu_torch.profile import profile_calls

    f64 = dtype == torch.float64
    if model == "sw":
        nel, s, dt = SW_TILE_MAIN
        geom, ops, metric, topology, q0 = sw_setup(nel, s)
        make, chain_rhs, shape = make_shard_map_sw_step_fused, ShallowWaterRHS, {"nel": nel, "s": s}
        points, nvar, limit = 6 * nel * nel * s * s, 3, 1e-10 if f64 else MASS_DRIFT_F32
        mass = lambda q: global_integral_2d(q[0].double().cpu().numpy(), ops, metric)
        tile_keys, other = ("sw_tile", "sw_pert_tile"), ("sw_operator", "sw_pert", "sw_edges", "sw_halo", "sw_run")
    else:
        nel_h, nel_v, s, dt = E3_TILE_MAIN
        nel = nel_h
        geom, ops, metric, topology, q0 = euler3d_setup(nel_h, nel_v, s, 31)
        make, chain_rhs = make_shard_map_euler3d_step_fused, Euler3DRHS
        shape = {"nel_h": nel_h, "nel_v": nel_v, "s": s}
        points, nvar, limit = 6 * nel_v * nel_h * nel_h * s**3, 5, 1e-11 if f64 else MASS_DRIFT_F32
        mass = lambda q: global_mass_3d(q.double().cpu().numpy(), ops, metric)
        tile_keys = ("euler3d_tile", "euler3d_pert_tile")
        other = ("euler3d_operator", "euler3d_pert", "euler3d_pert_stage", "euler3d_tangent")
    base = q0 if pert else None
    t0 = time.perf_counter()
    step = make(geom, ops, metric, TileMesh(n), dt, dtype=dtype, perturbation_base=base, device="cuda",
                topology=topology)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    q_init = torch.as_tensor(q0, dtype=dtype, device="cuda")

    def run():
        q = q_init
        for _ in range(TILE_STEPS):
            q = step(q)
        return q

    step(q_init)  # first launches (library load) outside the timed run
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    q = run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    want = {k: 0 for k in other + ("sw_plain_calls", "euler3d_plain_calls")}
    want[tile_keys[1 if pert else 0]] = 3 * 6 * n * n * TILE_STEPS
    want[tile_keys[0 if pert else 1]] = 0
    got = {k: counts[k] for k in want}
    name = f"{model} {'f64' if f64 else 'f32'} {'perturbation' if pert else 'absolute'} N={n}"
    if got != want:
        raise AssertionError(f"tile step {name}: launches {got}, expected {want}")
    if not bool(torch.isfinite(q).all()):
        raise AssertionError(f"tile step {name}: state not finite")
    if pert:  # the mass of q0 + the carried perturbation, in float64
        delta = torch.zeros(q0.shape, dtype=torch.float64, device="cuda")
        for i, pos in enumerate(step.positions):
            tile_view(delta, *pos, step.nt).copy_(step._cache[1][i])
        qm = torch.as_tensor(q0, device="cuda") + delta
    else:
        qm = q
    mass0 = mass(torch.as_tensor(q0) if pert else q_init)  # the run's own start (q_init is rounded to dtype)
    drift = (mass(qm) - mass0) / mass0
    prof = profile_calls(run)
    integ, qc = Tvdrk3(chain_rhs(geom, ops, metric, dtype=dtype, device="cuda", topology=topology,
                                 perturbation_base=base)), q_init
    for _ in range(TILE_STEPS):
        qc = integ.step(qc, dt)
    chain_m = torch.as_tensor(q0, device="cuda") + integ._cache[1].double() if pert else qc
    chain_drift = (mass(chain_m) - mass0) / mass0
    if not (f64 or pert):
        # The float32 absolute form rounds the absolute state each stage and
        # has no mass gate of its own: the tile step may drift no more than
        # twice the global chain does.
        limit = max(limit, 2.0 * abs(chain_drift))
    if not abs(drift) < limit:
        raise AssertionError(f"tile step {name}: mass drift {drift} (global chain {chain_drift}), limit {limit}")
    lead = (nvar,) + (1,) * (q.ndim - 1)
    if f64:
        err = float(((q - qc).abs() / per_variable_max(qc).reshape(lead)).max())
        tol = 1e-12
    else:
        change = per_variable_max((qc.double() - q_init.double())).reshape(lead)
        err = float(((q.double() - qc.double()).abs() / change).max())
        tol = GATE_REL
    if not err <= tol:
        raise AssertionError(f"tile step {name}: {err} from the global chain, limit {tol}")
    return dict(shape, model=model, n=n, tiles=6 * n * n, nt=nel // n, dtype=str(dtype).replace("torch.", ""),
                form="perturbation" if pert else "absolute", dt=dt, steps=TILE_STEPS, points=points,
                setup_s=setup_s, run_s=elapsed, steps_per_s=TILE_STEPS / elapsed,
                gridpoints_per_s=points * 3 * TILE_STEPS / elapsed,
                tile_launches_per_step=got[tile_keys[1 if pert else 0]] / TILE_STEPS,
                device_busy_share=prof["device_busy_share"] if prof["device_ops"] > 0 else None,
                device_ops_per_step=prof["device_ops"] / TILE_STEPS, kernels_us=prof["kernels_us"][:3],
                mass_drift=drift, global_chain_mass_drift=chain_drift, mass_limit=limit,
                err_vs_global_chain=err, tol=tol,
                err_scale="variable max" if f64 else "variable change over the run")


def phase26(torch):
    """The tile-parallel step at full width, every tile in this process."""
    rows = []
    for model, forms in (("sw", ((torch.float64, False), (torch.float32, False), (torch.float32, True))),
                         ("euler3d", ((torch.float64, False), (torch.float32, True)))):
        for dtype, pert in forms:
            for n in (1, 2):
                rows.append(_tile_run(torch, model, n, dtype, pert))
    emit({"phase": 26, "results": rows})
    launches = lambda model: sum(r["tile_launches_per_step"] * r["steps"] for r in rows if r["model"] == model)
    return {"sw_tile": int(launches("sw")), "euler3d_tile": int(launches("euler3d"))}


CLI_RANKS = 6


def _cli_ranks(torch, text, tag, last_step):
    """``python -m wxfactory_tpu_torch`` with CLI_RANKS processes sharing
    the card (gloo, host-staged halos), against one process in this one;
    every child is killed on the way out."""
    import socket

    from wxfactory_tpu_torch.config import Configuration
    from wxfactory_tpu_torch.output.state import load_state
    from wxfactory_tpu_torch.simulation import Simulation

    states = {}
    for mode in ("ranks", "single"):
        out_dir = WORK / f"phase27_{tag}_{mode}"
        out_dir.mkdir(parents=True, exist_ok=True)
        for old in glob.glob(str(out_dir / "state_vector_*")):
            Path(old).unlink()
        ini_text = text.format(out=out_dir, dist="shard_map" if mode == "ranks" else "off")
        if mode == "single":
            with contextlib.redirect_stdout(io.StringIO()):
                Simulation(Configuration(ini_text), device="cuda").run()
        else:
            ini = WORK / f"phase27_{tag}.ini"
            ini.write_text(ini_text)
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
            procs, logs = [], []
            t0 = time.perf_counter()
            try:
                for r in range(CLI_RANKS):
                    logs.append(open(WORK / f"phase27_{tag}_rank{r}.log", "w+"))
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "wxfactory_tpu_torch", str(ini), "--coordinator", f"localhost:{port}",
                         "--num-processes", str(CLI_RANKS), "--process-id", str(r)],
                        cwd=ROOT, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
                codes = [p.wait(timeout=300) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                for fh in logs:
                    fh.close()
            wall = time.perf_counter() - t0
            log0 = (WORK / f"phase27_{tag}_rank0.log").read_text()
            if codes != [0] * CLI_RANKS:
                raise AssertionError(f"{tag}: ranks exited with {codes}:\n{log0[-3000:]}")
            run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", log0)
            backend = re.search(r"distributed: .*", log0)
            if run is None or backend is None or "gloo" not in backend.group(0):
                raise AssertionError(f"{tag}: rank 0's log lacks the run or the backend line:\n{log0[-3000:]}")
        files = glob.glob(str(out_dir / f"state_vector_*.{last_step:08d}.npy"))
        if len(files) != 1:
            raise AssertionError(f"{tag} {mode}: checkpoint files {files}")
        states[mode] = load_state(files[0])[0]
    want = states["single"]
    scale = abs(want).reshape(want.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (want.ndim - 1))
    err = float((abs(states["ranks"] - want) / scale).max())
    if not err <= 1e-12:
        raise AssertionError(f"{tag}: the {CLI_RANKS}-rank checkpoint is {err} of scale from the single run's")
    return {"case": tag, "ranks": CLI_RANKS, "steps": int(run.group(1)), "wall_s": wall,
            "run_s": float(run.group(2)), "steps_per_s": float(run.group(3)), "backend": backend.group(0),
            "err_vs_single_process": err, "tol": 1e-12}


def phase27(torch):
    """The CLI with 6 ranks on the one card."""
    with_dist = lambda text: text.replace("precision = float64", "precision = float64\ndistribute = {dist}")
    case6 = with_dist(CASE6_INI.format(dt=20, t_end=400, nel=16, save=20, out="{out}"))
    dcmip31 = with_dist(DCMIP31_INI.format(dt=0.5, t_end=10, s=2, nel_h=12, nel_v=3, save=20, out="{out}",
                                           integrator="tvdrk3", verbose=0))
    rows = [_cli_ranks(torch, case6, "case6", 20), _cli_ranks(torch, dcmip31, "dcmip31", 20)]
    emit({"phase": 27, "results": rows,
          "note": "each rank is a process with its own CUDA context on the one card; gloo takes host tensors, so "
                  "every halo exchange copies the traces to the host and back: the run is host-bound"})


def phase28(torch, smi):
    """The card's time a call of the tile kernels at the tiles of phase 26."""
    from wxfactory_tpu_torch.kernels import check
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op
    from wxfactory_tpu_torch.ops import sw_operator as swop

    rows = []
    nel, s, dt = SW_TILE_MAIN
    for n in (1, 2):
        con64, base64, inputs64, _ = check.sw_tile_inputs(nel // n, s, n, "cuda")
        for dtype, pert in ((torch.float64, False), (torch.float32, False), (torch.float32, True)):
            name = str(dtype).replace("torch.", "")
            con, base = check.cast_constants(con64, dtype), check.cast_constants(base64, dtype)
            inp = {k: v.to(dtype) for k, v in inputs64.items()}
            y, h, x = (inp["dq"], inp["halo_dq"], inp["dx"]) if pert else (inp["y"], inp["halo_y"], inp["x"])
            kw = dict(x=x, a=0.75, b=0.25, cdt=0.25 * dt, emit_traces=True, base=base if pert else None)
            times = _pair_ms(torch, lambda: swop.sw_tile_operator(y, h, con, **kw),
                             lambda: swop.sw_tile_operator_plain(y, h, con, **kw))
            work = check.sw_tile_work(nel // n, s, dtype, stage=True, use_x=True, traces=True, pert=pert)
            resources = check.sw_kernel_resources(dtype, s)["perturbation" if pert else "absolute"]
            rows.append(dict({"kernel": "sw_tile", "nt": nel // n, "s": s, "n": n, "dtype": name,
                              "mode": ("pert_" if pert else "") + "stage_x_traces"}, **times, **_bound(work, name),
                             resources=resources))
    nel_h, nel_v, s, dt = E3_TILE_MAIN
    for n in (1, 2):
        con64, pert64, inputs64, _ = check.euler3d_tile_inputs(nel_h // n, nel_v, s, 31, n, "cuda")
        for dtype, pert in ((torch.float64, False), (torch.float32, True)):
            name = str(dtype).replace("torch.", "")
            con, base = check.cast_constants(con64, dtype), check.cast_constants(pert64, dtype)
            inp = {k: v.to(dtype) for k, v in inputs64.items()}
            y, h, x = (inp["dq"], inp["halo_dq"], inp["dx"]) if pert else (inp["y"], inp["halo_y"], inp["x"])
            kw = dict(x=x, a=0.75, b=0.25, cdt=0.25 * dt, emit_traces=True, pert=base if pert else None)
            times = _pair_ms(torch, lambda: e3op.euler3d_tile_operator(y, h, con, **kw),
                             lambda: e3op.euler3d_tile_operator_plain(y, h, con, **kw), n=10, n_plain=3)
            work = check.euler3d_tile_work(con, pert=pert, stage=True, use_x=True, traces=True)
            rows.append(dict({"kernel": "euler3d_tile", "nt": nel_h // n, "nk": nel_v, "s": s, "n": n,
                              "dtype": name, "mode": ("pert_" if pert else "") + "stage_x_traces"},
                             **times, **_bound(work, name)))
    emit({"phase": 28, "gpu": smi, "timing": "*_ms: the card's time a call (calls queued behind a sleep kernel, "
          "CUDA events); *_event_ms: CUDA events around single calls, median", "results": rows})
    main = lambda kernel, nt: next(r for r in rows if (r["kernel"], r["nt"], r["dtype"]) == (kernel, nt, "float64"))
    return {"sw_tile": main("sw_tile", SW_TILE_MAIN[0] // 2), "euler3d_tile": main("euler3d_tile", E3_MAIN[0] // 2)}


# Phase 29: the tangent kernels' shapes: case 6 at the EPI paths' widths
# (nel = 10, 30) and the operator's (64 at s = 3, 4, 7), then the other
# values of s; and the shapes it is timed at.
TANGENT_SHAPES = [(10, 3), (30, 3), (64, 3), (64, 4), (64, 7), (4, 2), (3, 5), (2, 6), (4, 8)]
TANGENT_TIMED = [(10, 3), (30, 3), (64, 3)]


def phase29(torch, smi):
    """The SW tangent kernels (J(q).v of the absolute operator: the prep once
    per linearisation point, the linear apply once per J.v) against the
    plain tangent (torch.func.jvp of the plain operator) and each against
    its plain version on the card, the apply's linearity, mass and
    centred-difference order, each one's time a call beside its bound and
    its plain version's, and their resources."""
    from wxfactory_tpu_torch.kernels import check
    from wxfactory_tpu_torch.ops import sw_operator as swop

    rows = [r for nel, s in TANGENT_SHAPES for dtype in (torch.float64, torch.float32)
            for r in check.compare_sw_tangent(nel, s, dtype, device="cuda")]
    emit_comparison(29, rows, ("nel", "s"))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"the tangent kernels disagree with their plain versions: {bad}")
    timing = []
    for nel, s in TANGENT_TIMED:
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).replace("torch.", "")
            con, topology, states, v, _ = check.sw_tangent_inputs(nel, s, dtype, "cuda")
            q = states["case6"]
            coef = swop.sw_tangent_prep(q, con, topology)
            prep = _pair_ms(torch, lambda: swop.sw_tangent_prep(q, con, topology),
                            lambda: swop.sw_tangent_prep_plain(q, con, topology), n=20, n_plain=3)
            apply = _pair_ms(torch, lambda: swop.sw_tangent_apply(coef, v, con, topology),
                             lambda: swop.sw_tangent_apply_plain(coef, v, con, topology), n=20, n_plain=3)
            row = {"nel": nel, "s": s, "dtype": name}
            for kernel, times, work in (("prep", prep, check.sw_tangent_prep_work(nel, s, dtype)),
                                        ("apply", apply, check.sw_tangent_apply_work(nel, s, dtype))):
                row.update({f"{kernel}_{k}": val for k, val in times.items()})
                row.update({f"{kernel}_own_{k}": val for k, val in _bound(work, name).items()})
            row.update({f"function_{k}": val for k, val in _bound(check.sw_tangent_work(nel, s, dtype), name).items()})
            row["jvp_ms"] = _device_ms(torch, lambda: swop.sw_tangent_plain(q, v, con, topology), 3)
            rhs = _bound(check.sw_work(nel, s, dtype, state=True), name)
            row["rhs_state_ms"] = _device_ms(torch, lambda: swop.sw_operator(q, None, con, topology=topology), 20)
            row["rhs_state_bound_ms"] = rhs["bound_ms"]
            timing.append(row)
    resources = {f"{str(dtype).replace('torch.', '')} s={s}": check.sw_tangent_resources(dtype, s)
                 for dtype in (torch.float64, torch.float32) for s in range(2, 9)}
    detail = [{k: r[k] for k in ("nel", "s", "dtype", "mode", "err", "limit", "linearity_err", "mass_err",
                                 "mass_of_output", "mass_of_plain", "prep_err", "apply_err", "prep_rows_over",
                                 "fd_order", "fd_err_p99", "fd_err_max")
               if k in r} for r in rows]
    emit({"phase": 29, "gpu": smi, "timing_note": "*_kernel_ms, *_plain_ms, jvp_ms, rhs_state_ms: the card's time "
          "a call (calls queued behind a sleep kernel, CUDA events); *_event_ms: CUDA events around single calls, "
          "median; prep_own/apply_own: each kernel's own bytes and operations; function: J(q).v from q and v",
          "timing": timing, "resources": resources, "checks": detail})
    main = [r for r in rows if (r["nel"], r["s"], r["dtype"]) == (10, 3, "float64")]
    return {"prep_max_abs_err": max(r["prep_max_abs_err"] for r in main),
            "apply_max_abs_err": max(max(r["max_abs_err"], r["apply_max_abs_err"]) for r in main),
            "timing": next(t for t in timing if (t["nel"], t["s"], t["dtype"]) == (10, 3, "float64"))}


SW_EPI_INI = """
[General]
equations = shallow_water
[System]
precision = float64
distribute = off
[Test_case]
case_number = {case}
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = {solver}
linear_solver = {linear_solver}
mixed_precision_krylov = {mixed}
tolerance = 1e-7
verbose_solver = 1
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = {nel}
[Grid]
grid_type = cubed_sphere
[Output_options]
save_state_freq = {steps}
stat_freq = {stat}
output_dir = {out}
"""
# Phase 30's runs: (tag, nel, dt, steps, integrator, exponential solver,
# linear solver, mixed_precision_krylov). (a) canonical run 1
# (tests/test_canonical_configs.py:28-39 of the JAX package), (b) its
# production form (bench.py:539-571 there), (c) that form at Galewsky's
# production width and step (bench.py:573-606, on case 6's state), (d) Ros2:
# FGMRES(20) with no preconditioner converges at nel = 10, dt = 1800 s in 35
# iterations (2 cycles; the port's CPU run).
SW_EPI_RUNS = [("a_epi3_pmex", 10, 1800.0, 5, "epi3", "pmex", "fgmres", 0),
               ("b_epi3_kiops_jit_mixed", 10, 1800.0, 5, "epi3", "kiops_jit", "fgmres", 1),
               ("c_epi3_kiops_jit_mixed_nel30", 30, 900.0, 4, "epi3", "kiops_jit", "fgmres", 1),
               ("d_ros2_fgmres_jit", 10, 1800.0, 2, "ros2", "pmex", "fgmres_jit", 0)]
PMEX_LINE = re.compile(r"pmex converged at iteration (\d+) \((\d+) substeps, (\d+) rejected\)")


def _sw_krylov(text):
    """(iterations, substeps, rejected) of each step the log reports: the
    EPI3 steps (the Epi2 bootstrap substeps print nothing) or the Ros2
    steps (iterations only)."""
    lines = [(int(m.group(1)), int(m.group(2)), int(m.group(3))) for m in PMEX_LINE.finditer(text)]
    lines += [(int(m.group(1)), int(m.group(2)), int(m.group(3))) for m in KIOPS_JIT_LINE.finditer(text)]
    lines += [(int(m.group(1)), 0, 0) for m in ROS2_LINE.finditer(text)]
    return lines


def _sw_run(torch, tag, nel, dt, nsteps, integrator, solver, linear_solver, mixed, device="cuda", case=6, s=3):
    """One shallow-water run through ``Simulation(ini).run()`` (the CLI's
    call) on ``device``: launch counts on the card (one state-mode operator
    launch an RHS call or RK stage, with topography for cases 5 and 10; one
    tangent apply launch a Jacobian action and one prep launch a
    linearisation point and dtype, with topography for case 5; no plain
    call), the Krylov statistics, host syncs, the final checkpoint (finite;
    case 6: 7,500 < h < 11,000), blockstats mass drift below 1e-10 (the
    Krylov tolerance with the mixed companion; the drift of the states' h
    integral for cases 0 and 1, which print no blockstats, as in the JAX
    package); returns (row, final state)."""
    import numpy as np

    from wxfactory_tpu_torch.output import global_integral_2d
    from wxfactory_tpu_torch.output.state import load_state
    from wxfactory_tpu_torch.simulation import Simulation

    out_dir = WORK / f"sw_{tag}_{device}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    big = nel * s >= 192
    ini = WORK / f"sw_{tag}_{device}.ini"
    ini.write_text(SW_EPI_INI.format(case=case, dt=dt, t_end=dt * nsteps, integrator=integrator, solver=solver,
                                     linear_solver=linear_solver, mixed=mixed, s=s, nel=nel, steps=nsteps,
                                     stat=nsteps if big else 1, out=out_dir))
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        sim = Simulation(str(ini), device=device)
        setup = time.perf_counter() - t0
        sim.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = log.getvalue()
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    krylov = _sw_krylov(text)
    if run is None:
        sys.stderr.write(text[-3000:])
        raise AssertionError(f"SW {tag} run on {device} did not complete; Krylov statistics {krylov}")
    if mixed and ("no effect" in text or "cannot consume" in text):
        raise AssertionError("mixed_precision_krylov was flagged as having no effect")
    topo = case in (5, 10)
    epi, explicit = integrator.startswith("epi"), integrator == "tvdrk3"
    # RHS calls: EPI3's first step one at q plus one a bootstrap Epi2
    # substep (10), then one a step; Ros2 one a step; TVD-RK3 three stages.
    rhs_calls = (11 + (nsteps - 1)) if epi else 3 * nsteps if explicit else nsteps
    reported = nsteps - 1 if epi else 0 if explicit else nsteps
    if len(krylov) != reported:
        raise AssertionError(f"{len(krylov)} Krylov reports in {nsteps} steps: {krylov}")
    if device == "cuda":
        # With the mixed companion its float64 base RHS at setup: the
        # halo-plane launch, or with topography the state mode's.
        want = {"sw_state": rhs_calls + (mixed if topo else 0), "sw_operator": rhs_calls + mixed,
                "sw_tangent_apply": counts["jacobian_actions"], "sw_tangent_prep": counts["linearisations"],
                "sw_operator_topo": rhs_calls + mixed if topo else 0, "sw_pert_topo": 0,
                "sw_tangent_apply_topo": counts["jacobian_actions"] if topo else 0,
                "sw_tangent_prep_topo": counts["linearisations"] if topo else 0,
                "sw_pert": 0, "sw_plain_calls": 0, "sw_plain_tangent_calls": 0}
        got = {k: counts[k] for k in want}
        if got != want or (not explicit and (counts["jacobian_actions"] == 0 or counts["linearisations"] == 0)):
            raise AssertionError(f"{tag}: launches {got} in {nsteps} {integrator} steps, expected {want}")
    drifts = [float(v) for v in re.findall(r"normalized error for mass = (\S+)", text)]
    files = glob.glob(str(out_dir / f"state_vector_*.{nsteps:08d}.npy"))
    if len(files) != 1:
        raise AssertionError(f"{tag}: checkpoint files {files}")
    state, _, _ = load_state(files[0])
    h = state[0]
    if state.shape != (3, 6, nel, nel, s * s) or not bool(np.isfinite(state).all()):
        raise AssertionError(f"{tag}: checkpoint state {state.shape} not finite or misshapen")
    if case == 6 and not (7500.0 < float(h.min()) and float(h.max()) < 11000.0):
        raise AssertionError(f"h in ({float(h.min())}, {float(h.max())}), outside (7500, 11000)")
    if case < 2:
        mass = lambda hh: global_integral_2d(hh, sim.ops, sim.metric)
        m0 = mass(sim.initial_q[0].double().cpu().numpy())
        drifts = [0.0, (mass(h) - m0) / m0]
    # float64 Krylov: the SW gate 1e-10; the float32 companion's basis: the
    # Krylov tolerance, as phase 15 holds the 3D mixed runs.
    drift_tol = 1e-7 if mixed else 1e-10
    if len(drifts) != (2 if big or case < 2 else nsteps + 1) or not max(abs(d) for d in drifts) < drift_tol:
        raise AssertionError(f"{tag}: blockstats mass drift {drifts}, limit {drift_tol}")
    run_s = float(run.group(2))
    row = {
        "tag": tag, "device": device, "case": case, "nel": nel, "s": s, "points": 6 * nel * nel * s * s,
        "dtype": "float64", "integrator": integrator, "exponential_solver": solver if epi else None,
        "linear_solver": linear_solver if integrator == "ros2" else None, "mixed_precision_krylov": mixed,
        "tolerance": 1e-7, "dt": dt, "steps": int(run.group(1)), "setup_s": setup, "run_s": run_s,
        "steps_per_s": float(run.group(3)), "main_wall_s": wall, "rhs_calls": rhs_calls,
        "jacobian_actions": counts["jacobian_actions"], "jacobian_actions_per_step": counts["jacobian_actions"] / nsteps,
        "linearisations": counts["linearisations"],
        "krylov_per_reported_step": krylov, "host_syncs": counts["host_syncs"],
        "host_syncs_per_step": counts["host_syncs"] / nsteps, "mass_drift_per_step": drifts[1:],
        "mass_drift_limit": drift_tol,
        "h_min": float(h.min()), "h_max": float(h.max()), "checkpoint": Path(files[0]).name,
    }
    if device == "cuda":
        row.update(operator_launches=counts["sw_operator"], state_launches=counts["sw_state"],
                   tangent_prep_launches=counts["sw_tangent_prep"], tangent_apply_launches=counts["sw_tangent_apply"],
                   edge_launches=counts["sw_edges"], halo_launches=counts["sw_halo"],
                   plain_calls=counts["sw_plain_calls"], plain_tangent_calls=counts["sw_plain_tangent_calls"],
                   topo_launches={k: counts[k] for k in ("sw_operator_topo", "sw_tangent_prep_topo",
                                                         "sw_tangent_apply_topo")},
                   pert_topo_launches=counts["sw_pert_topo"])
    return row, state


def phase30(torch):
    """The shallow-water exponential and Rosenbrock paths end to end through
    the CLI's call on the card, and run (a) against the port's own CPU run."""
    import numpy as np

    rows, states, launches = [], {}, None
    for tag, nel, dt, nsteps, integrator, solver, linear_solver, mixed in SW_EPI_RUNS:
        row, states[tag] = _sw_run(torch, tag, nel, dt, nsteps, integrator, solver, linear_solver, mixed)
        if tag.startswith("a_"):
            launches = {"sw_tangent_prep": row["tangent_prep_launches"], "sw_tangent_apply": row["tangent_apply_launches"]}
        rows.append(row)
    tag, nel, dt, nsteps, integrator, solver, linear_solver, mixed = SW_EPI_RUNS[0]
    cpu, cpu_state = _sw_run(torch, tag, nel, dt, nsteps, integrator, solver, linear_solver, mixed, device="cpu")
    scale = np.abs(cpu_state).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)
    err = float((np.abs(states[tag] - cpu_state) / scale).max())
    same_krylov = cpu["krylov_per_reported_step"] == rows[0]["krylov_per_reported_step"]
    emit({"phase": 30, "results": rows, "cpu_run_a": {
        "steps_per_s": cpu["steps_per_s"], "krylov_per_reported_step": cpu["krylov_per_reported_step"],
        "jacobian_actions": cpu["jacobian_actions"], "gpu_vs_cpu_err": err, "tol": 1e-9,
        "same_krylov": same_krylov}})
    if not (err <= 1e-9 and same_krylov and cpu["jacobian_actions"] == rows[0]["jacobian_actions"]):
        raise AssertionError(f"GPU and CPU EPI3 runs differ: {err} of scale, Krylov {rows[0]['krylov_per_reported_step']}"
                             f" against {cpu['krylov_per_reported_step']}")
    return launches


# Phase 31: the kernels with bottom topography (Williamson case 5) and the
# tangent pair at s = 1 (the fv-mg levels: nel 10 and 64 at s = 3 coarsen to
# FV grids of 20 and 10, 128 and 64 elements a panel edge).
TOPO_TIMED = [(10, 3), (64, 3)]
S1_SHAPES = [(4, 1), (10, 1), (20, 1), (64, 1), (128, 1)]
S1_TIMED = [(20, 1), (128, 1)]


def phase31(torch, smi):
    """The state mode with topography (RHS, stages) and the tangent pair with
    topography against their plain versions at SHAPES, float64 and float32
    (with mass; null planes bit for bit the kernels without topography,
    all-zero planes bit for bit null ones), the tangent pair at s = 1 at the
    fv-mg level shapes, and the card's time a call with and without
    topography beside the bounds."""
    from wxfactory_tpu_torch.kernels import check
    from wxfactory_tpu_torch.ops import sw_operator as swop

    dtypes = (torch.float64, torch.float32)
    op_rows = [r for nel, s in SHAPES for dtype in dtypes for r in check.compare_sw_topo_operator(nel, s, dtype, "cuda")]
    emit_comparison(31, op_rows, ("nel", "s"), tag="_topo_operator")
    tan_rows = [r for nel, s in SHAPES for dtype in dtypes
                for r in check.compare_sw_tangent(nel, s, dtype, device="cuda", case=5)]
    emit_comparison(31, tan_rows, ("nel", "s"), tag="_topo_tangent")
    s1_rows = [r for nel, s in S1_SHAPES for dtype in dtypes for r in check.compare_sw_tangent(nel, s, dtype, "cuda")]
    emit_comparison(31, s1_rows, ("nel", "s"), tag="_s1_tangent")
    bad = [r for r in op_rows + tan_rows + s1_rows if not r["ok"]]
    if bad:
        raise AssertionError(f"the topography or s = 1 kernels disagree with their plain versions: {bad}")

    timing = []
    for nel, s in TOPO_TIMED + S1_TIMED:
        for dtype in dtypes:
            name = str(dtype).replace("torch.", "")
            row = {"nel": nel, "s": s, "dtype": name}
            if s >= 2:
                con, topology, topo, _, y, _ = check.sw_topo_inputs(nel, s, dtype, "cuda")
                rhs = _pair_ms(torch, lambda: swop.sw_operator(y, None, con, topology=topology, topo=topo),
                               lambda: swop.sw_operator_plain(y, None, con, topology=topology, topo=topo), n=20,
                               n_plain=3)
                row.update({f"rhs_topo_{k}": v for k, v in rhs.items()})
                row.update({f"rhs_topo_{k}": v for k, v in _bound(check.sw_work(nel, s, dtype, state=True, topo=True),
                                                                   name).items()})
                row["rhs_ms"] = _device_ms(torch, lambda: swop.sw_operator(y, None, con, topology=topology), 20)
                row["rhs_bound_ms"] = _bound(check.sw_work(nel, s, dtype, state=True), name)["bound_ms"]
                tcon, _, states, v, _, ttopo = check.sw_topo_tangent_inputs(nel, s, dtype, "cuda")
                q = states["case5"]
            else:
                tcon, topology, states, v, _ = check.sw_tangent_inputs(nel, s, dtype, "cuda")
                q, ttopo = states["case6"], None
            coef = swop.sw_tangent_prep(q, tcon, topology, ttopo)
            tag = "_topo" if ttopo is not None else ""
            prep = _pair_ms(torch, lambda: swop.sw_tangent_prep(q, tcon, topology, ttopo),
                            lambda: swop.sw_tangent_prep_plain(q, tcon, topology, ttopo), n=20, n_plain=3)
            apply = _pair_ms(torch, lambda: swop.sw_tangent_apply(coef, v, tcon, topology, ttopo),
                             lambda: swop.sw_tangent_apply_plain(coef, v, tcon, topology, ttopo), n=20, n_plain=3)
            topo_on = ttopo is not None
            for kernel, times, work in (
                    ("prep", prep, check.sw_tangent_prep_work(nel, s, dtype, topo=topo_on)),
                    ("apply", apply, check.sw_tangent_apply_work(nel, s, dtype, topo=topo_on))):
                row.update({f"{kernel}{tag}_{k}": val for k, val in times.items()})
                row.update({f"{kernel}{tag}_own_{k}": val for k, val in _bound(work, name).items()})
            row.update({f"function{tag}_{k}": val
                        for k, val in _bound(check.sw_tangent_work(nel, s, dtype, topo=topo_on), name).items()})
            if topo_on:
                # the same pair without topography, on the same q and v
                coef0 = swop.sw_tangent_prep(q, tcon, topology)
                row["prep_ms"] = _device_ms(torch, lambda: swop.sw_tangent_prep(q, tcon, topology), 20)
                row["apply_ms"] = _device_ms(torch, lambda: swop.sw_tangent_apply(coef0, v, tcon, topology), 20)
            timing.append(row)
    resources = {f"{str(dtype).replace('torch.', '')} s={s}": {
        "tangent": check.sw_tangent_resources(dtype, s),
        **({"state_topo": check.sw_kernel_resources(dtype, s)["state_topo"]} if s >= 2 else {})}
        for dtype in dtypes for s in range(1, 9)}
    emit({"phase": 31, "gpu": smi, "timing_note": "*_kernel_ms, rhs_ms, prep_ms, apply_ms: the card's time a call "
          "(calls queued behind a sleep kernel, CUDA events); *_event_ms: CUDA events around single calls, median; "
          "*_topo: with case-5 topography; rhs_ms, prep_ms, apply_ms: the same call without topography; function: "
          "J(q).v from q and v", "timing": timing, "resources": resources})
    pick = lambda rows, nel, s: [r for r in rows if (r["nel"], r["s"], r["dtype"]) == (nel, s, "float64")]
    tmain = pick(tan_rows, 10, 3)
    return {"sw_operator_topo": max(r["max_abs_err"] for r in pick(op_rows, 10, 3)),
            "sw_tangent_prep_topo": max(r["prep_max_abs_err"] for r in tmain),
            "sw_tangent_apply_topo": max(max(r["max_abs_err"], r["apply_max_abs_err"]) for r in tmain),
            "sw_tangent_prep_s1": max(r["prep_max_abs_err"] for r in pick(s1_rows, 20, 1)),
            "sw_tangent_apply_s1": max(max(r["max_abs_err"], r["apply_max_abs_err"]) for r in pick(s1_rows, 20, 1)),
            "timing": timing}


# Phase 32's runs: (tag, nel, dt, steps, integrator, exponential solver,
# linear solver, mixed_precision_krylov, case, s). Case 5 at its canonical shape (reference
# config/case5.ini: nel = 10, s = 3) with EPI3 + pmex and at nel = 64 with
# TVD-RK3; Galewsky at the JAX package's EPI3 production point
# (bench.py:573-606: nel = 30, s = 3, dt = 900 s, kiops_jit mixed) and at
# (64, 7) with TVD-RK3, whose setup includes the balance quadrature; the
# other cases a few TVD-RK3 steps at nel = 10.
SW_CASE_RUNS = [("case5_epi3_pmex", 10, 1800.0, 5, "epi3", "pmex", "fgmres", 0, 5, 3),
                ("case5_tvdrk3_64", 64, 10.0, 30, "tvdrk3", "pmex", "fgmres", 0, 5, 3),
                ("galewsky_epi3_kiops_jit_mixed", 30, 900.0, 4, "epi3", "kiops_jit", "fgmres", 1, 8, 3),
                ("galewsky_tvdrk3_64_7", 64, 10.0, 10, "tvdrk3", "pmex", "fgmres", 0, 8, 7),
                ("case0", 10, 300.0, 3, "tvdrk3", "pmex", "fgmres", 0, 0, 3),
                ("case2", 10, 300.0, 3, "tvdrk3", "pmex", "fgmres", 0, 2, 3),
                ("case9", 10, 300.0, 3, "tvdrk3", "pmex", "fgmres", 0, 9, 3),
                ("case10", 10, 300.0, 3, "tvdrk3", "pmex", "fgmres", 0, 10, 3)]


def phase32(torch):
    """Every shallow-water case the port adds through the CLI's call on the
    card, case 1 stopping at its NaN guard as the JAX package's does, and the
    case-5 EPI3 run against the port's own CPU run."""
    import numpy as np

    from wxfactory_tpu_torch.simulation import Simulation

    rows, states, launches = [], {}, {}
    for run in SW_CASE_RUNS:
        reset_counts()
        row, states[run[0]] = _sw_run(torch, *run[:8], case=run[8], s=run[9])
        emit({"phase": 32, "run": run[0], "steps_per_s": row["steps_per_s"], "setup_s": row["setup_s"],
              "mass_drift": row["mass_drift_per_step"][-1]})
        for k, n in row["topo_launches"].items():
            launches[k] = launches.get(k, 0) + n
        rows.append(row)
    # Case 1: the bell leaves h = 0 outside it, where the operator divides 0
    # by 0; the JAX package's Simulation stops at step 1 with the same error.
    text = SW_EPI_INI.format(case=1, dt=300.0, t_end=900.0, integrator="tvdrk3", solver="pmex", linear_solver="fgmres",
                             mixed=0, s=3, nel=10, steps=3, stat=1, out=WORK / "phase32_case1")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            Simulation(_config(text), device="cuda").run()
        case1 = "ran"
    except RuntimeError as err:
        case1 = str(err)
    if case1 != "NaN/Inf detected in state after step 1":
        raise AssertionError(f"case 1: {case1}")
    run = SW_CASE_RUNS[0]
    cpu, cpu_state = _sw_run(torch, *run[:8], device="cpu", case=run[8], s=run[9])
    scale = np.abs(cpu_state).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)
    err = float((np.abs(states[SW_CASE_RUNS[0][0]] - cpu_state) / scale).max())
    same_krylov = cpu["krylov_per_reported_step"] == rows[0]["krylov_per_reported_step"]
    emit({"phase": 32, "results": rows, "case1": case1, "cpu_case5_epi3": {
        "steps_per_s": cpu["steps_per_s"], "krylov_per_reported_step": cpu["krylov_per_reported_step"],
        "gpu_vs_cpu_err": err, "tol": 1e-9, "same_krylov": same_krylov}})
    if not (err <= 1e-9 and same_krylov):
        raise AssertionError(f"GPU and CPU case-5 EPI3 runs differ: {err} of scale, Krylov "
                             f"{rows[0]['krylov_per_reported_step']} against {cpu['krylov_per_reported_step']}")
    return launches


def _config(text):
    from wxfactory_tpu_torch.config import Configuration

    return Configuration(text)


def _fgmres_solve(torch, A, b, restart, maxiter, pre=None):
    """One host FGMRES solve timed on the host (a final synchronize), with
    the Jacobian actions and host syncs it took."""
    from wxfactory_tpu_torch.common import device
    from wxfactory_tpu_torch.solvers import fgmres, matvec

    torch.cuda.synchronize()
    jv, syncs = matvec.jacobian_actions, device.host_syncs
    t0 = time.perf_counter()
    x, r, nb, it, flag, _ = fgmres(A, b, tol=1e-7, restart=restart, maxiter=maxiter, preconditioner=pre)
    torch.cuda.synchronize()
    return {"iterations": it, "relative_residual": r / nb, "residual": r, "flag": flag,
            "seconds": time.perf_counter() - t0, "system_jacobian_actions": matvec.jacobian_actions - jv,
            "host_syncs": device.host_syncs - syncs}


def _levels(mg):
    return [{"s": lv.num_solpts, "nel": lv.rhs.con.nel, "preps": lv.preps, "applies": lv.applies} for lv in mg.levels]


PMG_CASE5 = dict(kind="p-mg", num_levels=2, num_pre_smoothe=1, num_post_smoothe=1, pseudo_cfl=720.0, smoother="kiops")
FVMG_CASE5 = dict(PMG_CASE5, kind="fv-mg", num_levels=3)

# The preconditioners of phase 33's Ros2 runs (without one: the same
# Simulation with its preconditioner removed). dcmip31 takes the erk3
# smoother: the kiops smoother's Arnoldi stops at its first vector there
# (its happy-breakdown test is absolute, at its tolerance 1e-2) and returns
# a zero correction, on which FGMRES breaks down (the JAX package's
# smoother alike, ROADMAP.md section 3).
ROS2_PRE_SW = """
[Preconditioning]
preconditioner = {pre}
num_mg_levels = 2
mg_smoother = kiops
pseudo_cfl = 720
"""
# FGMRES iterations of phase 33's unpreconditioned dcmip31 step.
ROS2_E3_BUDGET = 2000
ROS2_PRE_E3 = """
[Preconditioning]
preconditioner = {pre}
num_mg_levels = 2
mg_smoother = erk3
pseudo_cfl = 5
"""
FGMRES_LINE = re.compile(r"fgmres (convergence|stagnation) at iteration (\d+)")
FGMRES_JIT_LINE = re.compile(r"FGMRES\(jit\) (convergence|stagnation) at iteration (\d+)")


def _ros2_pre_pair(torch, tag, text, nsteps, budget=None):
    """A Ros2 run through ``Simulation(ini).run()`` with the INI's p-mg
    preconditioner (the host FGMRES, which ``auto`` takes with one), then
    the same run on the same Simulation with no preconditioner (``auto``:
    the device FGMRES, with at most ``budget`` iterations a step when
    given): FGMRES iterations a step, steps/s, the levels' prep and apply
    launches, no plain call."""
    from wxfactory_tpu_torch.simulation import Simulation

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        sim = Simulation(_config(text), device="cuda")
    setup = time.perf_counter() - t0
    pc = sim.integrator.preconditioner
    rows = []
    for pre in ("p-mg", "none"):
        if pre == "none":
            sim.integrator.preconditioner = None
            if budget is not None:
                sim.integrator.max_iterations = budget
        log = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            sim.run()
        wall = time.perf_counter() - t0
        counts = read_counts()
        out = log.getvalue()
        run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", out)
        if run is None:
            sys.stderr.write(out[-3000:])
            raise AssertionError(f"Ros2 {tag} with {pre} did not complete")
        found = (FGMRES_LINE if pre == "p-mg" else FGMRES_JIT_LINE).findall(out)
        row = {"tag": tag, "preconditioner": pre, "setup_s": setup, "steps": int(run.group(1)),
               "steps_per_s": float(run.group(3)), "run_s": float(run.group(2)), "wall_s": wall,
               "fgmres_iterations_per_step": [int(i) for _, i in found], "solver": [k for k, _ in found],
               "jacobian_actions": counts["jacobian_actions"], "linearisations": counts["linearisations"],
               "host_syncs_per_step": counts["host_syncs"] / nsteps,
               "launches": {k: counts[k] for k in ("sw_tangent_prep", "sw_tangent_apply", "sw_tangent_prep_topo",
                                                   "sw_tangent_apply_topo", "euler3d_tangent_prep",
                                                   "euler3d_tangent", "sw_plain_calls", "sw_plain_tangent_calls",
                                                   "euler3d_plain_calls", "plain_tangent_calls")}}
        if pre == "p-mg":
            row["levels"] = [{"s": lv.num_solpts, "preps": lv.preps, "applies": lv.applies} for lv in pc.levels]
        if len(found) != nsteps:
            raise AssertionError(f"Ros2 {tag} with {pre}: {len(found)} solver reports in {nsteps} steps")
        plain = sum(row["launches"][k] for k in ("sw_plain_calls", "sw_plain_tangent_calls", "euler3d_plain_calls",
                                                 "plain_tangent_calls"))
        if plain:
            raise AssertionError(f"Ros2 {tag} with {pre} ran plain versions: {row['launches']}")
        rows.append(row)
    return rows


def phase33(torch):
    """The preconditioned solves on the card: the case-5 rational system by
    FGMRES(100) alone and with 2-level p-mg (kiops smoother) against the
    JAX package's gate (tests/test_framework.py:316-317), and with 3-level
    fv-mg (the s = 1 tangent pair on its FV levels); Ros2 with p-mg through
    Simulation on case 5 and on dcmip31 at 20x20x3, s = 3, dt = 30 s, each
    beside the run without a preconditioner; lu and ilu at nel = 4, s = 2."""
    from wxfactory_tpu_torch.kernels.check import sw_topo_setup
    from wxfactory_tpu_torch.models import ShallowWaterRHS
    from wxfactory_tpu_torch.precondition import Factorization, Multigrid
    from wxfactory_tpu_torch.solvers import make_rat_matvec

    def system(nel, s, dt=3600.0):
        geom, ops, metric, topology, q0, topo = sw_topo_setup(nel, s)
        rhs = ShallowWaterRHS(geom, ops, metric, device="cuda", topology=topology, topo=topo)
        q = torch.as_tensor(q0, device="cuda")
        return geom, q, make_rat_matvec(rhs, q, dt), (rhs(q) * dt).reshape(-1), rhs

    result = {}
    launches = {}
    geom, q, A, b, rhs = system(10, 3)
    reset_counts()
    result["plain"] = _fgmres_solve(torch, A, b, 100, 3)
    for name, kw in (("p-mg", PMG_CASE5), ("fv-mg", FVMG_CASE5)):
        reset_counts()
        t0 = time.perf_counter()
        mg = Multigrid.for_geometry(geom, device="cuda", **kw)
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        mg.prepare(3600.0, q)
        torch.cuda.synchronize()
        prepare = time.perf_counter() - t0
        row = _fgmres_solve(torch, A, b, 100, 3, mg)
        counts = read_counts()
        row.update(setup_s=setup, prepare_s=prepare, levels=_levels(mg),
                   launches={k: counts[k] for k in ("sw_tangent_prep", "sw_tangent_apply", "sw_tangent_prep_topo",
                                                    "sw_tangent_apply_topo", "sw_tangent_prep_s1",
                                                    "sw_tangent_apply_s1", "sw_plain_calls",
                                                    "sw_plain_tangent_calls")})
        if row["launches"]["sw_plain_calls"] or row["launches"]["sw_plain_tangent_calls"]:
            raise AssertionError(f"{name} ran plain versions: {row['launches']}")
        if name == "fv-mg":
            launches = {k: counts[k] for k in ("sw_tangent_prep_s1", "sw_tangent_apply_s1")}
        result[name] = row
        emit({"phase": 33, "solve": name, **row})
    plain, pmg, fvmg = result["plain"], result["p-mg"], result["fv-mg"]
    gate = {"pmg_4x": pmg["iterations"] * 4 <= plain["iterations"],
            "pmg_residual": pmg["residual"] <= 1.05 * plain["residual"],
            "fvmg_iterations": fvmg["iterations"] <= plain["iterations"],
            "fvmg_residual": fvmg["residual"] <= 1.05 * plain["residual"],
            "fvmg_on_s1_kernels": launches.get("sw_tangent_apply_s1", 0) > 0}
    result["gate"] = gate

    # lu and ilu at nel = 4, s = 2 (their dense Jacobian: 1,152 columns).
    _, q4, A4, b4, rhs4 = system(4, 2)
    reset_counts()
    result["plain_4_2"] = _fgmres_solve(torch, A4, b4, 30, 3)
    for kind in ("lu", "ilu"):
        f = Factorization(rhs4, kind)
        t0 = time.perf_counter()
        f.prepare(3600.0, q4)
        prepare = time.perf_counter() - t0
        row = _fgmres_solve(torch, A4, b4, 30, 3, f)
        row["prepare_s"] = prepare
        result[kind] = row
        emit({"phase": 33, "solve": kind, **row})
        gate[f"{kind}_converged"] = row["flag"] == 0 and row["iterations"] < result["plain_4_2"]["iterations"]

    ros2 = []
    sw = SW_EPI_INI.format(case=5, dt=1800.0, t_end=3600.0, integrator="ros2", solver="pmex", linear_solver="auto",
                           mixed=0, s=3, nel=10, steps=0, stat=0, out=WORK / "phase33_sw")
    # dcmip31 at 20x20x3: 3 levels keep the script within its time limit.
    e3 = DCMIP31_INI.format(dt=30, t_end=30, integrator="ros2", verbose=1, s=3, nel_h=20, nel_v=3, save=0,
                            out=WORK / "phase33_e3")
    # The unpreconditioned dcmip31 solve stagnates (PERF.md §7 Q5); 2,000
    # iterations of the 20,000 budget show it and keep the script inside its
    # time limit.
    for tag, text, extra, nsteps, budget in (("sw_case5", sw, ROS2_PRE_SW, 2, None),
                                             ("dcmip31_20x20x3", e3, ROS2_PRE_E3, 1, ROS2_E3_BUDGET)):
        for row in _ros2_pre_pair(torch, tag, text + extra.format(pre="p-mg"), nsteps, budget):
            ros2.append(row)
            emit({"phase": 33, "ros2": tag, **row})
    result["ros2"] = ros2
    emit({"phase": 33, **result})
    if not all(gate.values()):
        raise AssertionError(f"phase 33 gates failed: {gate}")
    return launches


# Phase 34: the terrain kernels' shapes (nel_h, nel_v, s) and the DCMIP 20,
# 21 and 22 paths.
TERRAIN_SHAPES = [(4, 3, 3), (3, 2, 2), (20, 20, 3)]
TERRAIN_MAIN = (20, 20, 3)
TERRAIN_INI = """
[General]
equations = euler
[System]
precision = float64
[Test_case]
case_number = {case}
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = {solver}
mixed_precision_krylov = {mixed}
device_step_chunk = {chunk}
tolerance = 1e-7
verbose_solver = 1
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = {nel_h}
num_elements_vertical = {nel_v}
[Grid]
grid_type = cubed_sphere
ztop = {ztop}
[Output_options]
save_state_freq = 0
output_dir = {out}
"""
# (tag, case, nel_h, nel_v, s, dt, steps, integrator, exponential solver, mixed, chunk): paths (a)-(d).
TERRAIN_RUNS = [("a_dcmip21_tvdrk3", 21, 20, 20, 3, 0.1, 60, "tvdrk3", "kiops", 0, 1),
                ("b_dcmip21_epi2_kiops", 21, 20, 10, 3, 2.0, 3, "epi2", "kiops", 0, 1),
                ("c_dcmip20_epi2_kiops_jit_mixed", 20, 20, 10, 3, 30.0, 5, "epi2", "kiops_jit", 1, 5),
                ("d_dcmip22_tvdrk3", 22, 20, 10, 3, 0.1, 60, "tvdrk3", "kiops", 0, 1)]
TERRAIN_TILE = (20, 0.1, 20)  # DCMIP 20 at TERRAIN_MAIN: (case, dt, steps) of the tile step, path (e)
TERRAIN_MASS_DRIFT = 1e-11
# The counters a terrain path may move; every other operator counter and the plain calls must stay 0.
TERRAIN_COUNTERS = ("euler3d_terrain", "euler3d_terrain_pert", "euler3d_terrain_tangent_prep",
                    "euler3d_terrain_tangent_apply")
E3_OTHER_COUNTERS = ("euler3d_operator", "euler3d_tangent", "euler3d_tangent_prep", "euler3d_pert",
                     "euler3d_pert_stage", "euler3d_pert_tangent", "euler3d_plain_calls", "plain_tangent_calls",
                     "euler3d_tile", "euler3d_pert_tile")


def _terrain_ini(tag, case, nel_h, nel_v, s, dt, nsteps, integrator, solver, mixed, chunk):
    from wxfactory_tpu_torch.kernels.check import DCMIP_ZTOP

    ini = WORK / f"dcmip{case}_{tag}.ini"
    ini.write_text(TERRAIN_INI.format(case=case, dt=dt, t_end=dt * nsteps, integrator=integrator, solver=solver,
                                      mixed=mixed, chunk=chunk, s=s, nel_h=nel_h, nel_v=nel_v,
                                      ztop=DCMIP_ZTOP[case], out=WORK / f"phase34_{tag}"))
    return ini


def _terrain_run(torch, tag, case, nel_h, nel_v, s, dt, nsteps, integrator, solver, mixed, chunk):
    """One DCMIP 20/21/22 run through ``Simulation(ini).run()`` (the CLI's
    call) on the card, the INI written under build/: its launches (terrain
    instantiations only, no plain call: one operator launch a TVD-RK3
    stage; an EPI2 step one RHS, one prep and one apply a Jacobian action;
    the mixed companion's float64 base RHS at setup), a finite state, mass
    drift, max |w| and steps/s."""
    from wxfactory_tpu_torch.common.device import forbid_uncounted_syncs
    from wxfactory_tpu_torch.output import global_mass_3d
    from wxfactory_tpu_torch.simulation import Simulation

    ini = _terrain_ini(tag, case, nel_h, nel_v, s, dt, nsteps, integrator, solver, mixed, chunk)
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        sim = Simulation(str(ini), device="cuda")
        setup = time.perf_counter() - t0
        with forbid_uncounted_syncs() if solver == "kiops_jit" else contextlib.nullcontext():
            q = sim.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = log.getvalue()
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    if run is None:
        sys.stderr.write(text[-3000:])
        raise AssertionError(f"terrain path {tag} did not complete")
    if "no effect" in text or "cannot consume" in text:
        raise AssertionError(f"terrain path {tag}: mixed_precision_krylov flagged as having no effect")
    want = {k: 0 for k in E3_OTHER_COUNTERS + TERRAIN_COUNTERS}
    actions = counts["jacobian_actions"]
    if integrator == "tvdrk3":
        want["euler3d_terrain"] = 3 * nsteps
    else:
        want.update(euler3d_terrain=nsteps + mixed, euler3d_terrain_tangent_prep=nsteps,
                    euler3d_terrain_tangent_apply=actions)
        if actions == 0:
            raise AssertionError(f"terrain path {tag}: no Jacobian action")
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"terrain path {tag}: launches {got}, expected {want}")
    q0 = sim.initial_q
    finite = bool(torch.isfinite(q).all())
    m0 = global_mass_3d(q0.cpu().numpy(), sim.ops, sim.metric)
    drift = (global_mass_3d(q.cpu().numpy(), sim.ops, sim.metric) - m0) / m0
    krylov = [tuple(int(x) for x in m) for m in re.findall(r"converged at iteration (\d+) \((\d+) substeps", text)]
    row = {"tag": tag, "case": case, "nel_h": nel_h, "nel_v": nel_v, "s": s, "ztop": sim.geom.ztop, "dt": dt,
           "integrator": integrator, "exponential_solver": solver if integrator != "tvdrk3" else None,
           "mixed_precision_krylov": mixed, "steps": int(run.group(1)), "setup_s": setup, "run_s": float(run.group(2)),
           "steps_per_s": float(run.group(3)), "wall_s": wall, "launches": got, "jacobian_actions": actions,
           "krylov_per_step": krylov, "host_syncs": counts["host_syncs"], "finite": finite, "mass_drift": drift,
           "mass_limit": TERRAIN_MASS_DRIFT, "max_abs_w": float((q[3] / q[0]).abs().max()),
           "max_abs_w_initial": float((q0[3] / q0[0]).abs().max()),
           "max_abs_rho_w_change": float((q[3] - q0[3]).abs().max())}
    row["ok"] = finite and abs(drift) <= TERRAIN_MASS_DRIFT
    emit({"phase": 34, "path": row})
    if not row["ok"]:
        raise AssertionError(f"terrain path {tag}: finite {finite}, mass drift {drift}")
    return row


def _terrain_tile(torch):
    """Path (e): the tile-parallel TVD-RK3 step of DCMIP 20 at N = 1, every
    tile in this process (each tile on its own panel's slice of the
    per-panel metric): float64 absolute against the global chain on the
    terrain kernels, bit for bit; float32 perturbation form (the production
    explicit point) against its global chain, whose stages are the terrain
    perturbation kernel, within the bench's gate; launches, mass, steps/s."""
    from wxfactory_tpu_torch.integrators import Tvdrk3
    from wxfactory_tpu_torch.kernels.check import euler3d_setup, per_variable_max
    from wxfactory_tpu_torch.models import Euler3DRHS
    from wxfactory_tpu_torch.output import global_mass_3d
    from wxfactory_tpu_torch.parallel import TileMesh
    from wxfactory_tpu_torch.parallel.shard_map_euler3d_fused import make_shard_map_euler3d_step_fused

    case, dt, nsteps = TERRAIN_TILE
    geom, ops, metric, topology, q0 = euler3d_setup(*TERRAIN_MAIN, case)
    mass = lambda q: global_mass_3d(q.double().cpu().numpy(), ops, metric)
    rows, chain_launches = [], 0
    for dtype, pert in ((torch.float64, False), (torch.float32, True)):
        base = q0 if pert else None
        step = make_shard_map_euler3d_step_fused(geom, ops, metric, TileMesh(1), dt, dtype=dtype,
                                                 perturbation_base=base, device="cuda", topology=topology)
        q_init = torch.as_tensor(q0, dtype=dtype, device="cuda")
        step(q_init)  # the library's first launches outside the counted run
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        q = q_init
        for _ in range(nsteps):
            q = step(q)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = read_counts()
        tile_key = "euler3d_pert_tile" if pert else "euler3d_tile"
        want = {k: 0 for k in E3_OTHER_COUNTERS + TERRAIN_COUNTERS}
        want[tile_key] = 3 * 6 * nsteps
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"terrain tile step ({dtype}): launches {got}, expected {want}")
        rhs = Euler3DRHS(geom, ops, metric, dtype=dtype, device="cuda", topology=topology, perturbation_base=base)
        integ = Tvdrk3(rhs)
        reset_counts()
        qc = q_init
        for _ in range(nsteps):
            qc = integ.step(qc, dt)
        torch.cuda.synchronize()
        counts = read_counts()
        chain_key = "euler3d_terrain_pert" if pert else "euler3d_terrain"
        if counts[chain_key] != 3 * nsteps or counts["euler3d_pert_stage"] or counts["euler3d_operator"]:
            raise AssertionError(f"terrain global chain ({dtype}): launches {counts}")
        if pert:
            chain_launches = counts[chain_key]
        m0 = mass(torch.as_tensor(q0))
        drift = (mass(q) - m0) / m0
        f64 = dtype == torch.float64
        if f64:
            identical = bool(torch.equal(q, qc))
            err = float(((q - qc).abs() / per_variable_max(qc).reshape(5, 1, 1, 1, 1, 1)).max())
            ok = identical
        else:
            change = per_variable_max(qc.double() - q_init.double()).reshape(5, 1, 1, 1, 1, 1)
            err = float(((q.double() - qc.double()).abs() / change).max())
            identical = bool(torch.equal(q, qc))
            ok = err <= GATE_REL
        limit = TERRAIN_MASS_DRIFT if f64 else MASS_DRIFT_F32
        row = {"tag": "e_dcmip20_tile_n1", "case": case, "nel_h": TERRAIN_MAIN[0], "nel_v": TERRAIN_MAIN[1],
               "s": TERRAIN_MAIN[2], "dtype": str(dtype).replace("torch.", ""),
               "form": "perturbation" if pert else "absolute", "dt": dt, "steps": nsteps, "run_s": elapsed,
               "steps_per_s": nsteps / elapsed, "tile_launches": got[tile_key],
               "global_chain_launches": counts[chain_key], "identical_to_global_chain": identical,
               "err_vs_global_chain": err, "tol": 0.0 if f64 else GATE_REL, "finite": bool(torch.isfinite(q).all()),
               "mass_drift": drift, "mass_limit": limit, "max_abs_w": float((q[3] / q[0]).abs().max())}
        row["ok"] = ok and row["finite"] and abs(drift) <= limit
        emit({"phase": 34, "path": row})
        if not row["ok"]:
            raise AssertionError(f"terrain tile step ({dtype}) failed: {row}")
        rows.append(row)
        del step, rhs, integ
        torch.cuda.empty_cache()
    return rows, chain_launches


def _terrain_cpu_pair(torch):
    """DCMIP 20 and 21 at 4x3x3 (TVD-RK3, dt = 0.5 s, 10 steps) on the card
    and on the CPU (the plain versions): final states within 1e-10 of each
    variable's max, and each one's max |w| (DCMIP 20's: the terrain
    error of a state that should stay at rest)."""
    from wxfactory_tpu_torch.simulation import Simulation

    rows = []
    for case in (20, 21):
        ini = _terrain_ini(f"cpu_pair_{case}", case, 4, 3, 3, 0.5, 10, "tvdrk3", "kiops", 0, 1)
        states = {}
        for device in ("cuda", "cpu"):
            with contextlib.redirect_stdout(io.StringIO()):
                states[device] = Simulation(str(ini), device=device).run().cpu()
        want, got = states["cpu"], states["cuda"]
        scale = want.abs().reshape(5, -1).amax(dim=1).reshape(5, 1, 1, 1, 1, 1)
        err = float(((got - want).abs() / scale).max())
        w = {d: float((q[3] / q[0]).abs().max()) for d, q in states.items()}
        rows.append({"case": case, "nel_h": 4, "nel_v": 3, "s": 3, "dt": 0.5, "steps": 10, "err": err, "tol": 1e-10,
                     "max_abs_w_gpu": w["cuda"], "max_abs_w_cpu": w["cpu"], "ok": err <= 1e-10})
    emit({"phase": 34, "gpu_vs_cpu": rows})
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"GPU and CPU terrain runs differ: {rows}")
    return rows


def _terrain_timing(torch, smi):
    """The card's time a call at TERRAIN_MAIN of the terrain instantiations
    (f64: DCMIP 21 with its sponge, absolute RHS, stage + x + traces, prep
    and apply; f32: DCMIP 20's perturbation form, RHS, stage + traces, prep
    and apply), each in turns with the same call of the kernels without
    terrain on DCMIP 31 at the same shape (20 calls queued behind a sleep
    kernel), the plain versions (CUDA events, median), the bounds
    (kernels/check.py, six panels' metric and the sponge's planes counted)
    and the terrain kernels' resources."""
    from wxfactory_tpu_torch.kernels.check import (euler3d_inputs, euler3d_pert_inputs, euler3d_pert_work,
                                                   euler3d_tangent_apply_work, euler3d_tangent_inputs,
                                                   euler3d_tangent_prep_work, euler3d_tangent_work, euler3d_work,
                                                   pert_halos, tangent_halos, terrain_kernel_resources)
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op

    rows = []
    for dtype, case in ((torch.float64, 21), (torch.float32, 20)):
        name = str(dtype).replace("torch.", "")
        fns, bounds = {}, {}
        for tag, c in (("terrain", case), ("flat", 31)):
            if dtype == torch.float64:
                con, topology, x, y = euler3d_inputs(*TERRAIN_MAIN, dtype, "cuda", c)
                halo = e3op.halo_from_traces(e3op.edge_traces(y, con), topology)
                _, _, q, v = euler3d_tangent_inputs(*TERRAIN_MAIN, dtype, "cuda", c)
                halo_q, halo_v = tangent_halos(q, v, con, topology)
                coef = e3op.euler3d_tangent_prep(q, halo_q, con)
                calls = {
                    "rhs": (lambda y=y, h=halo, c_=con: e3op.euler3d_operator(y, h, c_),
                            lambda y=y, h=halo, c_=con: e3op.euler3d_operator_plain(y, h, c_), euler3d_work(con)),
                    "stage_x_traces": (
                        lambda y=y, h=halo, c_=con, x=x: e3op.euler3d_operator(y, h, c_, x=x, a=0.75, b=0.25,
                                                                              cdt=0.025, emit_traces=True),
                        lambda y=y, h=halo, c_=con, x=x: e3op.euler3d_operator_plain(y, h, c_, x=x, a=0.75, b=0.25,
                                                                                    cdt=0.025, emit_traces=True),
                        euler3d_work(con, stage=True, use_x=True, traces=True)),
                    "prep": (lambda q=q, h=halo_q, c_=con: e3op.euler3d_tangent_prep(q, h, c_),
                             lambda q=q, h=halo_q, c_=con: e3op.euler3d_tangent_prep_plain(q, h, c_),
                             euler3d_tangent_prep_work(con)),
                    "apply": (lambda v=v, h=halo_v, k=coef, c_=con: e3op.euler3d_tangent_apply(v, h, k, c_),
                              lambda v=v, h=halo_v, k=coef, c_=con: e3op.euler3d_tangent_apply_plain(v, h, k, c_),
                              euler3d_tangent_work(con)),
                }
                floor = euler3d_tangent_apply_work(con)
            else:
                con, topology, pert, dq, v = euler3d_pert_inputs(*TERRAIN_MAIN, dtype, "cuda", c)
                halo_dq, halo_v = pert_halos(dq, v, pert, con, topology)
                coef = e3op.euler3d_tangent_prep(dq, halo_dq, con, pert)
                calls = {
                    "rhs": (lambda d=dq, h=halo_dq, c_=con, b=pert: e3op.euler3d_operator(d, h, c_, pert=b),
                            lambda d=dq, h=halo_dq, c_=con, b=pert: e3op.euler3d_operator_pert_plain(d, h, c_, b),
                            euler3d_pert_work(con)),
                    "stage_traces": (
                        lambda d=dq, h=halo_dq, c_=con, b=pert: e3op.euler3d_operator(d, h, c_, b=1.0, cdt=0.1,
                                                                                     emit_traces=True, pert=b),
                        lambda d=dq, h=halo_dq, c_=con, b=pert: e3op.euler3d_operator_pert_plain(
                            d, h, c_, b, b=1.0, cdt=0.1, emit_traces=True),
                        euler3d_pert_work(con, stage=True, traces=True)),
                    "prep": (lambda d=dq, h=halo_dq, c_=con, b=pert: e3op.euler3d_tangent_prep(d, h, c_, b),
                             lambda d=dq, h=halo_dq, c_=con, b=pert: e3op.euler3d_tangent_prep_plain(d, h, c_, b),
                             euler3d_tangent_prep_work(con, pert=True)),
                    "apply": (lambda v=v, h=halo_v, k=coef, c_=con: e3op.euler3d_tangent_apply(v, h, k, c_),
                              lambda v=v, h=halo_v, k=coef, c_=con: e3op.euler3d_tangent_apply_plain(v, h, k, c_),
                              euler3d_pert_work(con, tangent=True)),
                }
                floor = euler3d_tangent_apply_work(con)
            fns[tag] = calls
            bounds[tag] = {mode: _bound(work, name) for mode, (_, _, work) in calls.items()}
            bounds[tag]["apply_floor"] = _bound(floor, name)
        row = {"nel_h": TERRAIN_MAIN[0], "nel_v": TERRAIN_MAIN[1], "s": TERRAIN_MAIN[2], "dtype": name,
               "case": case, "form": "absolute" if dtype == torch.float64 else "perturbation",
               "flat_case": 31}
        for mode in fns["terrain"]:
            terrain, flat = fns["terrain"][mode][0], fns["flat"][mode][0]
            for fn in (terrain, flat):
                fn()
            t_times, f_times = [], []
            for fn, times in ((flat, f_times), (terrain, t_times), (terrain, t_times), (flat, f_times)):
                times.append(_device_ms(torch, fn, 20))
            row[f"{mode}_ms"] = statistics.median(t_times)
            row[f"{mode}_ms_turns"] = t_times
            row[f"{mode}_flat_ms"] = statistics.median(f_times)
            row[f"{mode}_flat_ms_turns"] = f_times
            row[f"{mode}_plain_ms"] = statistics.median(_event_times(torch, fns["terrain"][mode][1], n=3))
            b = bounds["terrain"][mode]
            row[f"{mode}_bytes"], row[f"{mode}_ops"] = b["bytes"], b["ops"]
            row[f"{mode}_bound_ms"], row[f"{mode}_bound_by"] = b["bound_ms"], b["bound_by"]
            row[f"{mode}_flat_bound_ms"] = bounds["flat"][mode]["bound_ms"]
        row["apply_floor_ms"] = bounds["terrain"]["apply_floor"]["bound_ms"]
        row["apply_floor_bytes"] = bounds["terrain"]["apply_floor"]["bytes"]
        row["resources"] = terrain_kernel_resources(dtype, TERRAIN_MAIN[2])
        rows.append(row)
        del fns
        torch.cuda.empty_cache()
    emit({"phase": 34, "gpu": smi, "timing": "the card's time a call (20 calls queued behind a sleep kernel, CUDA "
          "events), terrain and flat (DCMIP 31, the kernels without terrain) in turns; plain: CUDA events around "
          "single calls, median", "results": rows})
    return rows


def phase34(torch, smi):
    """DCMIP 20, 21 and 22 over terrain: the terrain instantiations of the
    3D operator (interface and volume passes), the tangent prep and the
    apply against their plain versions at TERRAIN_SHAPES, float64 and
    float32 (DCMIP 21 absolute with its sponge; DCMIP 20 absolute and in
    the perturbation form; every operator call holding mass), the terrain
    kernels on flat constants bit for bit the kernels without terrain, their
    times at TERRAIN_MAIN beside those kernels', and paths (a)-(e)."""
    from wxfactory_tpu_torch.kernels.check import (compare_euler3d_operator, compare_euler3d_pert,
                                                   compare_euler3d_pert_stage, compare_euler3d_tangent,
                                                   compare_sponge_rows, compare_terrain_flat)

    rows = []
    for nel_h, nel_v, s in TERRAIN_SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows += compare_euler3d_operator(nel_h, nel_v, s, dtype, device="cuda", case=21)
            rows += compare_euler3d_operator(nel_h, nel_v, s, dtype, device="cuda", case=20)
            rows.append(compare_euler3d_tangent(nel_h, nel_v, s, dtype, device="cuda", case=21))
            rows += compare_euler3d_pert(nel_h, nel_v, s, dtype, device="cuda", case=20)
            rows += compare_euler3d_pert_stage(nel_h, nel_v, s, dtype, device="cuda", case=20)
            rows.append(compare_terrain_flat(nel_h, nel_v, s, dtype, device="cuda"))
            rows.append(compare_sponge_rows(nel_h, nel_v, s, dtype, device="cuda"))
    emit_comparison(34, rows, ("nel_h", "nel_v", "s", "case"))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"terrain kernels disagree with their plain versions: {bad}")
    # The kernels line's errors: at TERRAIN_MAIN, from the rows of the dtype
    # each entry is timed in (float64: DCMIP 21; float32: DCMIP 20's
    # perturbation form), each beside the max |value| of what it measures
    # (for a prep, of the coefficient row where the error is largest).
    def err(dtype, key, scale_key, keep):
        at_main = [r for r in rows if (r["nel_h"], r["nel_v"], r["s"]) == TERRAIN_MAIN and r["dtype"] == dtype
                   and keep(r)]
        worst = max(at_main, key=lambda r: r[key])
        out = {"max_abs_err": worst[key], "err_scale": worst[scale_key], "err_dtype": dtype}
        if key == "prep_max_abs_err":
            out["err_row"] = worst["prep_max_abs_row"]
        return out

    absolute = ("rhs", "stage", "stage_x", "stage_x_traces")
    tangent21 = lambda r: r["case"] == 21 and r["mode"] == "tangent"
    pert_tangent = lambda r: r["mode"] == "pert_tangent"
    errors = {
        "euler3d_operator_terrain": err("float64", "max_abs_err", "output_max",
                                        lambda r: r["case"] == 21 and r["mode"] in absolute),
        "euler3d_pert_stage_terrain": err("float32", "max_abs_err", "output_max",
                                          lambda r: r["mode"].startswith("pert_stage")),
        "euler3d_tangent_prep_terrain": err("float64", "prep_max_abs_err", "prep_max_abs_row_max", tangent21),
        "euler3d_tangent_apply_terrain": err("float64", "apply_max_abs_err", "apply_output_max", tangent21),
        "euler3d_pert_tangent_prep_terrain": err("float32", "prep_max_abs_err", "prep_max_abs_row_max", pert_tangent),
        "euler3d_pert_tangent_apply_terrain": err("float32", "apply_max_abs_err", "apply_output_max", pert_tangent),
    }
    timing = _terrain_timing(torch, smi)
    pair = _terrain_cpu_pair(torch)
    paths = [_terrain_run(torch, *run) for run in TERRAIN_RUNS]
    tile, chain_launches = _terrain_tile(torch)
    by_tag = {r["tag"]: r for r in paths}
    launches = {
        "euler3d_operator_terrain": sum(r["launches"]["euler3d_terrain"] for r in paths),
        "euler3d_pert_stage_terrain": chain_launches,
        "euler3d_tangent_prep_terrain": by_tag["b_dcmip21_epi2_kiops"]["launches"]["euler3d_terrain_tangent_prep"],
        "euler3d_tangent_apply_terrain": by_tag["b_dcmip21_epi2_kiops"]["launches"]["euler3d_terrain_tangent_apply"],
        "euler3d_pert_tangent_prep_terrain":
            by_tag["c_dcmip20_epi2_kiops_jit_mixed"]["launches"]["euler3d_terrain_tangent_prep"],
        "euler3d_pert_tangent_apply_terrain":
            by_tag["c_dcmip20_epi2_kiops_jit_mixed"]["launches"]["euler3d_terrain_tangent_apply"],
    }
    w20 = {"tile_f64": tile[0]["max_abs_w"], "epi2_kiops_jit_mixed": by_tag["c_dcmip20_epi2_kiops_jit_mixed"][
        "max_abs_w"], "gpu_4x3x3": pair[0]["max_abs_w_gpu"], "cpu_4x3x3": pair[0]["max_abs_w_cpu"]}
    emit({"phase": 34, "dcmip20_max_abs_w": w20,
          "steps_per_s": {r["tag"] + (f"_{r['dtype']}" if "dtype" in r else ""): r["steps_per_s"]
                          for r in paths + tile}})
    return {"errors": errors, "launches": launches, "timing": timing}


# Phase 35: the perturbation form with bottom topography (the float32
# companion and production point of Williamson cases 5 and 10) and the
# output layer. The kernel's shapes, its timed shape, the Simulation runs
# (tag, nel, dt, steps, integrator, exponential solver, linear solver,
# mixed_precision_krylov, case): the case-5 EPI3 + kiops_jit mixed runs at
# the reference's shape (config/case5.ini: nel = 10, s = 3) and at the JAX
# package's EPI3 production width (bench.py:573-606: nel = 30, dt = 900 s),
# case 10 at nel = 10, and Ros2 + fgmres_jit mixed.
PERT_TOPO_SHAPES = [(10, 3), (64, 3), (4, 2), (64, 7)]
PERT_TOPO_TIMED = (64, 3)
SW_TOPO_MIXED_RUNS = [("a_case5_epi3_kiops_jit_mixed", 10, 1800.0, 5, "epi3", "kiops_jit", "fgmres", 1, 5),
                      ("b_case5_epi3_kiops_jit_mixed_nel30", 30, 900.0, 4, "epi3", "kiops_jit", "fgmres", 1, 5),
                      ("c_case10_epi3_kiops_jit_mixed", 10, 1800.0, 5, "epi3", "kiops_jit", "fgmres", 1, 10),
                      ("d_case5_ros2_fgmres_jit_mixed", 10, 1800.0, 2, "ros2", "pmex", "fgmres_jit", 1, 5)]
# (c): the float32 perturbation TVD-RK3 chain of case 5 (nel, s, dt, steps).
SW_TOPO_CHAIN = (64, 3, 10.0, 30)
OUTPUT_KNOBS = "output_freq = 1\nstore_solver_stats = 1\nrhs_timing_freq = 2\nstore_total_time = 1\nbase_output_file = case5\n"
RHS_STAGES = ["full_rhs(fused)", "extrapolation", "interior_derivative", "halo_exchange"]


def _pert_topo_timing(torch, smi):
    """The card's time a call of the perturbation kernel with topography at
    PERT_TOPO_TIMED (RHS and stage + x, float32 and float64), in turns
    with the perturbation kernel without topography on case 6's base, the
    plain version's, the bound of kernels/check.py, and the kernels'
    resources."""
    from wxfactory_tpu_torch.kernels import check
    from wxfactory_tpu_torch.ops import sw_operator as swop

    nel, s = PERT_TOPO_TIMED
    rows = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        con, topology, base, topo, dq, x = check.sw_pert_topo_inputs(nel, s, dtype, "cuda")
        fcon, _, fbase, fdq, fx = check.sw_pert_inputs(nel, s, dtype, "cuda")
        row = {"nel": nel, "s": s, "dtype": name}
        for mode, kw, fkw in (("rhs", {}, {}),
                              ("stage_x", dict(x=x, a=0.75, b=0.25, cdt=7.5), dict(x=fx, a=0.75, b=0.25, cdt=7.5))):
            kernel = lambda: swop.sw_operator(dq, None, con, base=base, topology=topology, topo=topo, **kw)
            flat = lambda: swop.sw_operator(fdq, None, fcon, base=fbase, topology=topology, **fkw)
            plain = lambda: swop.sw_operator_pert_plain(dq, None, con, base, topology=topology, topo=topo, **kw)
            for fn in (kernel, flat):
                fn()
            torch.cuda.synchronize()
            turns = {"kernel": [], "flat": []}
            for which in ("flat", "kernel", "kernel", "flat"):
                turns[which].append(_device_ms(torch, kernel if which == "kernel" else flat, 20))
            row[f"{mode}_kernel_ms"] = statistics.median(turns["kernel"])
            row[f"{mode}_kernel_turns_ms"] = turns["kernel"]
            row[f"{mode}_flat_ms"] = statistics.median(turns["flat"])
            row[f"{mode}_flat_turns_ms"] = turns["flat"]
            row[f"{mode}_plain_ms"] = _device_ms(torch, plain, 3)
            work = check.sw_work(nel, s, dtype, stage=mode != "rhs", use_x=mode != "rhs", pert=True, state=True,
                                 topo=True)
            row.update({f"{mode}_{k}": v for k, v in _bound(work, name).items()})
            row[f"{mode}_flat_bound_ms"] = _bound(check.sw_work(nel, s, dtype, stage=mode != "rhs",
                                                                use_x=mode != "rhs", pert=True, state=True),
                                                  name)["bound_ms"]
        rows.append(row)
    resources = {f"{str(dtype).replace('torch.', '')} s={s}": {
        k: v for k, v in check.sw_kernel_resources(dtype, s).items() if k in ("state_perturbation", "state_pert_topo")}
        for dtype in (torch.float32, torch.float64) for s in sorted({s for _, s in PERT_TOPO_SHAPES})}
    return {"gpu": smi, "timing_note": "*_kernel_ms, *_flat_ms: the card's time a call (20 calls queued behind a "
            "sleep kernel, CUDA events), median of two turns each in the order flat, kernel, kernel, flat; flat: "
            "the perturbation kernel without topography on case 6's base; *_plain_ms: the plain version, 3 calls",
            "timing": rows, "resources": resources}


def _sw_topo_chain(torch):
    """(c): the float32 perturbation TVD-RK3 chain of case 5 at
    SW_TOPO_CHAIN: its setup's launches (the base's edge and halo kernels
    and the float64 base RHS on the absolute kernel with topography), one
    perturbation launch with topography a stage and nothing else, mass, and
    bench.py:425-446's gate (the f32 perturbation RHS against the f64
    truth at the state four f64 TVD-RK3 steps of dt = 150 (10/nel)(3/s) on,
    scaled by each variable's tendency max), beside the f32 absolute
    kernel's error."""
    from wxfactory_tpu_torch.integrators import Tvdrk3
    from wxfactory_tpu_torch.kernels.check import _scaled, per_variable_max, sw_topo_setup
    from wxfactory_tpu_torch.models import ShallowWaterRHS
    from wxfactory_tpu_torch.output.diagnostics import global_integral_2d

    nel, s, dt, nsteps = SW_TOPO_CHAIN
    geom, ops, metric, topology, q0, topo = sw_topo_setup(nel, s)
    reset_counts()
    t0 = time.perf_counter()
    rhs = ShallowWaterRHS(geom, ops, metric, dtype=torch.float32, device="cuda", topology=topology,
                          perturbation_base=q0, topo=topo)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counts = read_counts()
    setup_want = {"sw_edges": 1, "sw_halo": 1, "sw_operator": 1, "sw_operator_topo": 1, "sw_state": 1,
                  "sw_pert": 0, "sw_pert_topo": 0, "sw_plain_calls": 0}
    setup_launches = {k: counts[k] for k in setup_want}
    if setup_launches != setup_want:
        raise AssertionError(f"case-5 perturbation base: launches {setup_launches}, expected {setup_want}")
    rhs64 = ShallowWaterRHS(geom, ops, metric, device="cuda", topology=topology, topo=topo)
    gdt = 150.0 * (10.0 / nel) * (3.0 / s)
    q = torch.as_tensor(q0, device="cuda")
    for _ in range(4):
        k1 = q + gdt * rhs64(q)
        k2 = 0.75 * q + 0.25 * (k1 + gdt * rhs64(k1))
        q = q / 3.0 + 2.0 / 3.0 * (k2 + gdt * rhs64(k2))
    truth = rhs64(q)
    scale = per_variable_max(truth)
    gate = _scaled(rhs.delta((q - rhs.base_state.double()).float()).double() - truth, scale)
    abs32 = ShallowWaterRHS(geom, ops, metric, dtype=torch.float32, device="cuda", topology=topology, topo=topo)
    gate_abs = _scaled(abs32(q.float()).double() - truth, scale)
    if not gate < GATE_REL:
        raise AssertionError(f"case-5 f32 perturbation RHS {gate} of the tendency scale from the f64 truth, gate "
                             f"{GATE_REL}")
    q_init = torch.as_tensor(q0, dtype=torch.float32, device="cuda")
    Tvdrk3(rhs).step(q_init, dt)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    integ, qs = Tvdrk3(rhs), q_init
    for _ in range(nsteps):
        qs = integ.step(qs, dt)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    want = {"sw_pert": 3 * nsteps, "sw_pert_topo": 3 * nsteps, "sw_state": 3 * nsteps, "sw_operator": 0,
            "sw_operator_topo": 0, "sw_halo": 0, "sw_edges": 0, "sw_plain_calls": 0}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"case-5 f32 perturbation chain: launches {got}, expected {want}")
    mass = lambda t: global_integral_2d(t[0].double().cpu().numpy(), ops, metric)
    drift = (mass(qs) - mass(q_init)) / mass(q_init)
    if not (bool(torch.isfinite(qs).all()) and abs(drift) < MASS_DRIFT_F32):
        raise AssertionError(f"case-5 f32 perturbation chain: finite {bool(torch.isfinite(qs).all())}, mass "
                             f"drift {drift}")
    points = 6 * nel * nel * s * s
    return {"case": 5, "nel": nel, "s": s, "points": points, "dtype": "float32", "form": "perturbation",
            "integrator": "tvdrk3", "dt": dt, "steps": nsteps, "setup_s": setup_s, "chained_s": elapsed,
            "chained_gridpoints_per_s": points * 3 * nsteps / elapsed, "chained_steps_per_s": nsteps / elapsed,
            "setup_launches": setup_launches, "chained_launches": got, "mass_drift": drift,
            "gate_err": gate, "gate_err_f32_absolute": gate_abs, "gate": GATE_REL}


def _output_run(torch, tag, text, nsteps):
    """One run through the CLI (``python -m wxfactory_tpu_torch``'s main) of
    an INI; returns (exit code, its stdout, seconds, steps/s, counts)."""
    from wxfactory_tpu_torch import __main__ as cli

    ini = WORK / f"phase35_{tag}.ini"
    ini.write_text(text)
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(ini), "--device", "cuda"])
    wall = time.perf_counter() - t0
    out = log.getvalue()
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", out)
    if rc != 0 or run is None or int(run.group(1)) != nsteps:
        sys.stderr.write(out[-3000:])
        raise AssertionError(f"phase 35 {tag}: the CLI exited with {rc}")
    return out, wall, float(run.group(3)), read_counts()


def _fresh(path):
    if path.exists():
        for old in path.iterdir():
            old.unlink()
    path.mkdir(parents=True, exist_ok=True)
    return path


def _outputs(torch):
    """(d): the output layer through the CLI: case 5 EPI3 + pmex at nel = 10
    with every output knob on and again with none (steps/s of both), then
    dcmip31 TVD-RK3 at 12x12x3, s = 2, with field output; each file read
    back (scipy): the number of writes, the last write's h (rho) against the
    final checkpoint's h + hsurf (rho), the solver-stats rows and RHS timing
    stages, the runtime line."""
    import sqlite3

    import numpy as np
    from scipy.io import netcdf_file

    from wxfactory_tpu_torch.kernels.check import sw_topo_setup
    from wxfactory_tpu_torch.output.netcdf import _to_single_block_3d
    from wxfactory_tpu_torch.output.state import load_state

    nsteps, nel, s = 4, 10, 3
    rows = {}
    for tag, knobs in (("sw_outputs", OUTPUT_KNOBS), ("sw_no_outputs", "")):
        out_dir = _fresh(WORK / f"phase35_{tag}")
        text = SW_EPI_INI.format(case=5, dt=1800.0, t_end=1800.0 * nsteps, integrator="epi3", solver="pmex",
                                 linear_solver="fgmres", mixed=0, s=s, nel=nel, steps=nsteps, stat=0,
                                 out=out_dir) + knobs
        log, wall, rate, counts = _output_run(torch, tag, text, nsteps)
        if counts["sw_plain_calls"] or counts["sw_plain_tangent_calls"] or counts["sw_pert"]:
            raise AssertionError(f"phase 35 {tag}: plain calls or perturbation launches {counts}")
        rows[tag] = {"steps_per_s": rate, "wall_s": wall, "host_syncs": counts["host_syncs"],
                     "operator_topo_launches": counts["sw_operator_topo"]}
        if not knobs:
            continue
        state, _, _ = load_state(glob.glob(str(out_dir / f"state_vector_*.{nsteps:08d}.npy"))[0])
        geom, _, _, _, _, topo = sw_topo_setup(nel, s)
        with netcdf_file(str(out_dir / "case5.nc"), "r", mmap=False) as f:
            h = np.array(f.variables["h"][:])
            times = np.array(f.variables["time"][:])
            fields = sorted(f.variables)
        want_h = geom.to_single_block(state[0] + topo.hsurf)
        h_err = float(np.abs(h[-1] - want_h).max() / np.abs(want_h).max())
        db = sqlite3.connect(str(out_dir / "solver_stats.db"))
        results = db.execute("SELECT step_id, num_iterations FROM results_data").fetchall()
        timing = db.execute("SELECT step_id, stage, elapsed FROM rhs_timing").fetchall()
        db.close()
        runtime = (out_dir / "runtime_epi3.txt").read_text().split()
        ok = (h.shape[0] == nsteps + 1 and h_err <= 1e-12 and list(times) == [1800.0 * k for k in range(nsteps + 1)]
              and [r[0] for r in results] == list(range(2, nsteps + 1))
              and [(r[0], r[1]) for r in timing] == [(k, st) for k in range(2, nsteps + 1, 2) for st in RHS_STAGES]
              and all(r[2] > 0 for r in timing) and runtime[:4] == ["pmex", str(nel), "epi3", "5"])
        rows[tag].update(writes=int(h.shape[0]), fields=fields, h_err=h_err, results_rows=len(results),
                         iterations=[r[1] for r in results], rhs_timing_s={st: [r[2] for r in timing if r[1] == st]
                                                                            for st in RHS_STAGES},
                         runtime_line=" ".join(runtime), ok=ok)
        if not ok:
            raise AssertionError(f"phase 35 case-5 outputs: {rows[tag]}")

    e3_steps, e3_freq = 10, 5
    out_dir = _fresh(WORK / "phase35_dcmip31")
    text = DCMIP31_INI.format(dt=0.5, t_end=0.5 * e3_steps, integrator="tvdrk3", verbose=0, s=2, nel_h=12,
                              nel_v=3, save=e3_steps, out=out_dir) + f"output_freq = {e3_freq}\nbase_output_file = e3\n"
    log, wall, rate, counts = _output_run(torch, "dcmip31", text, e3_steps)
    state, _, _ = load_state(glob.glob(str(out_dir / f"state_vector_*.{e3_steps:08d}.npy"))[0])
    with netcdf_file(str(out_dir / "e3.nc"), "r", mmap=False) as f:
        rho = np.array(f.variables["rho"][:])
        fields = sorted(f.variables)
    want = _to_single_block_3d(state[0], 3, 12, 2)
    rho_err = float(np.abs(rho[-1] - want).max() / np.abs(want).max())
    row = {"steps_per_s": rate, "wall_s": wall, "writes": int(rho.shape[0]), "fields": fields, "rho_err": rho_err,
           "operator_launches": counts["euler3d_operator"]}
    if not (rho.shape[0] == e3_steps // e3_freq + 1 and rho_err <= 1e-12 and counts["euler3d_plain_calls"] == 0):
        raise AssertionError(f"phase 35 dcmip31 outputs: {row}")
    rows["dcmip31_outputs"] = row
    return rows


def phase35(torch, smi):
    """The perturbation form's state mode with topography against its plain
    version at PERT_TOPO_SHAPES (f64, f32; RHS, stage, stage + x; mass),
    its card time beside the kernel without topography, (b) the mixed
    companion of cases 5 and 10 through Simulation(ini).run() and the card
    against the CPU at (4, 3), (c) case 5's float32 chain, (d) the output
    layer through the CLI."""
    import numpy as np

    from wxfactory_tpu_torch.kernels import check

    rows = [r for nel, s in PERT_TOPO_SHAPES for dtype in (torch.float64, torch.float32)
            for r in check.compare_sw_pert_topo(nel, s, dtype, "cuda")]
    emit_comparison(35, rows, ("nel", "s"), tag="_pert_topo")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"the perturbation kernel with topography disagrees with its plain version: {bad}")
    timing = _pert_topo_timing(torch, smi)
    emit({"phase": 35, **timing, "zero_equals_flat": all(r["zero_equals_flat"] for r in rows)})

    runs, totals = [], {}
    for run in SW_TOPO_MIXED_RUNS:
        row, _ = _sw_run(torch, *run[:8], case=run[8])
        if row["topo_launches"]["sw_tangent_apply_topo"] == 0 or row["pert_topo_launches"]:
            raise AssertionError(f"{run[0]}: launches {row['topo_launches']}, perturbation {row['pert_topo_launches']}")
        runs.append(row)
        for k, n in row["topo_launches"].items():
            totals[k] = totals.get(k, 0) + n
    pair = ("e_case5_epi3_kiops_jit_mixed_4x3", 4, 1800.0, 2, "epi3", "kiops_jit", "fgmres", 1)
    card, card_state = _sw_run(torch, *pair, case=5)
    cpu, cpu_state = _sw_run(torch, *pair, device="cpu", case=5)
    scale = np.abs(cpu_state).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)
    err = float((np.abs(card_state - cpu_state) / scale).max())
    emit({"phase": 35, "results": runs, "card_vs_cpu_4x3": {"err": err, "tol": 2e-5,
                                                           "card_steps_per_s": card["steps_per_s"],
                                                           "cpu_steps_per_s": cpu["steps_per_s"]}})
    if not err <= 2e-5:
        raise AssertionError(f"case-5 mixed EPI3 on the card and the CPU differ by {err} of scale")

    chain = _sw_topo_chain(torch)
    outputs = _outputs(torch)
    emit({"phase": 35, "chain": chain, "outputs": outputs})
    nel, s = PERT_TOPO_TIMED
    main = [r for r in rows if (r["nel"], r["s"], r["dtype"]) == (nel, s, "float32")]
    return {"timing": timing, "launches": chain["chained_launches"]["sw_pert_topo"], "topo_launches": totals,
            "max_abs_err": max(r["max_abs_err"] for r in main)}


# Phase 36: the integrators and solvers of ROADMAP item 12 through
# Simulation(ini).run(), on the ported operator and tangent kernels only.
# The exponential solvers of the schema that the port gained (kiops_nest is
# no schema name: tests/test_torch_lowsync.py holds it).
NEW_EXP_SOLVERS = ["pmex_1s", "pmex_ne1s", "cwy_1s", "cwy_ne", "cwy_ne1s", "icwy_1s", "icwy_ne", "icwy_ne1s",
                   "icwy_neiop", "dcgs2", "exode"]
# (tag, model, shape, dt, steps, time_integrator, exponential_solver,
# linear_solver, expfilter). Shallow water: case 6, s = 3, shape = nel; 3D:
# dcmip31, s = 2, shape = (nel_h, nel_v). The implicit paths run at dt =
# 1800 s, where the JAX package's Newton converges in 3-8 iterations a solve
# on case 6 at nel = 2 and the port's at nel = 10 in 3-7 (tests/
# test_torch_implicit.py; the port's CPU run at nel = 10).
ITEM12_RUNS = (
    [(f"a_epi3_{n}", "sw", 10, 1800.0, 2, "epi3", n, "fgmres", False) for n in NEW_EXP_SOLVERS]
    + [("a_srerk3_kiops", "sw", 10, 1800.0, 2, "srerk3", "kiops", "fgmres", False),
       ("a_srerk6_pmex", "sw", 10, 1800.0, 2, "srerk6", "pmex", "fgmres", False),
       ("b_srerk3_kiops_nel30", "sw", 30, 900.0, 2, "srerk3", "kiops", "fgmres", False),
       ("b_epi3_icwy_1s_nel30", "sw", 30, 900.0, 2, "epi3", "icwy_1s", "fgmres", False),
       ("c_backward_euler", "sw", 10, 1800.0, 1, "backward_euler", "pmex", "fgmres", False),
       ("c_crank_nicolson", "sw", 10, 1800.0, 1, "crank_nicolson", "pmex", "fgmres", False),
       ("c_bdf2", "sw", 10, 1800.0, 2, "bdf2", "pmex", "fgmres", False),
       ("c_sdirk", "sw", 10, 1800.0, 1, "sdirk", "pmex", "fgmres", False),
       ("c_rosexp2", "sw", 10, 1800.0, 1, "rosexp2", "pmex", "fgmres", False),
       ("c_ros2_gcrot", "sw", 10, 1800.0, 1, "ros2", "pmex", "gcrot", False),
       ("d_srerk3_pmex", "e3", (12, 3), 30.0, 2, "srerk3", "pmex", "fgmres", False),
       ("d_epi2_icwy_1s", "e3", (12, 3), 30.0, 2, "epi2", "icwy_1s", "fgmres", False),
       ("d_crank_nicolson", "e3", (12, 3), 30.0, 2, "crank_nicolson", "pmex", "fgmres", False),
       ("d_epi2_icwy_1s_expfilter", "e3", (12, 3), 30.0, 2, "epi2", "icwy_1s", "fgmres", True)])
ITEM12_INI = """
[General]
equations = {equations}
[System]
precision = float64
distribute = off
[Test_case]
case_number = {case}
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = {solver}
linear_solver = {linear_solver}
tolerance = 1e-7
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = {nel_h}
{vertical}{filters}
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Output_options]
save_state_freq = 0
stat_freq = 0
output_dir = {out}
"""
ITEM12_FILTER = "expfilter_apply = 1\nexpfilter_order = 16\nexpfilter_cutoff = 0.5\nexpfilter_strength = 0.1\n"


def _item12_run(torch, run, device="cuda"):
    """One path of phase 36 through ``Simulation(ini).run()`` on ``device``:
    every step of the integrator inside ``forbid_uncounted_syncs`` on the
    card (each host wait a counted read), its solver statistics a step, and
    on the card the launch gates: no plain call, one tangent apply a
    Jacobian action and one prep a linearisation, operator launches only in
    the state mode (shallow water); then a finite state and the mass drift.
    Returns (row, final state as numpy)."""
    import numpy as np

    from wxfactory_tpu_torch.common.device import forbid_uncounted_syncs
    from wxfactory_tpu_torch.output import global_integral_2d, global_mass_3d
    from wxfactory_tpu_torch.simulation import Simulation

    # EXODE's step-size warm start lives in its module: start each path as
    # a fresh process does.
    sys.modules["wxfactory_tpu_torch.solvers.exode"]._state["first_step"] = None
    tag, model, shape, dt, nsteps, integrator, solver, linear_solver, expfilter = run
    sw = model == "sw"
    nel_h, nel_v = (shape, None) if sw else shape
    s = 3 if sw else 2
    out_dir = WORK / f"item12_{tag}_{device}"
    out_dir.mkdir(parents=True, exist_ok=True)
    ini = WORK / f"item12_{tag}_{device}.ini"
    ini.write_text(ITEM12_INI.format(
        equations="shallow_water" if sw else "euler", case=6 if sw else 31, dt=dt, t_end=dt * nsteps,
        integrator=integrator, solver=solver, linear_solver=linear_solver, s=s, nel_h=nel_h,
        vertical="" if sw else f"num_elements_vertical = {nel_v}\n", filters=ITEM12_FILTER if expfilter else "",
        out=out_dir))
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        sim = Simulation(str(ini), device=device)
        if device == "cpu" and sw:
            # The CPU's Jacobian action: the tangent kernels' plain pair
            # (prep once a linearisation, apply an action; ~1/20 of the
            # model's torch.func.jvp), the plain versions of what the card
            # launches.
            from wxfactory_tpu_torch.kernels.check import PlainPairShallowWater

            sim.rhs.__class__ = PlainPairShallowWater
        setup = time.perf_counter() - t0
        integ, per_step = sim.integrator, []
        plain_step = integ.step

        def step(q, step_dt):
            with forbid_uncounted_syncs():
                q = plain_step(q, step_dt)
            info = integ.solver_info or integ.init_method.solver_info  # an EPI bootstrap step: its Epi2's
            per_step.append((info.total_num_it, info.num_substeps, info.num_rejected))
            return q

        integ.step = step
        q = sim.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = log.getvalue()
    done = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    if done is None or int(done.group(1)) != nsteps:
        sys.stderr.write(text[-3000:])
        raise AssertionError(f"phase 36 {tag} on {device} did not complete {nsteps} steps")
    if "WARNING" in text:
        raise AssertionError(f"phase 36 {tag}: {text[text.index('WARNING'):][:300]}")
    state = q.cpu().numpy()
    q0 = sim.initial_q.cpu().numpy()
    if sw:
        mass = lambda x: global_integral_2d(x[0], sim.ops, sim.metric)
    else:
        mass = lambda x: global_mass_3d(x, sim.ops, sim.metric)
    drift = (mass(state) - mass(q0)) / mass(q0)
    # Float64 and conservative: 1e-10 on shallow water (phase 30's gate);
    # 3D: the KIOPS tolerance, as phase 11 (the first step's update cancels
    # ~12 orders at the balanced initial state).
    drift_tol = 1e-10 if sw else 1e-7
    if not (bool(np.isfinite(state).all()) and abs(drift) < drift_tol):
        raise AssertionError(f"phase 36 {tag} on {device}: finite {bool(np.isfinite(state).all())}, "
                             f"mass drift {drift} (limit {drift_tol})")
    if sw and not (7500.0 < float(state[0].min()) and float(state[0].max()) < 11000.0):
        raise AssertionError(f"phase 36 {tag}: h in ({float(state[0].min())}, {float(state[0].max())})")
    row = {"tag": tag, "device": device, "model": "case 6" if sw else "dcmip31", "nel_h": nel_h, "nel_v": nel_v,
           "s": s, "dt": dt, "steps": nsteps, "time_integrator": integrator, "exponential_solver": solver,
           "linear_solver": linear_solver, "expfilter": expfilter, "setup_s": setup, "run_s": float(done.group(2)),
           "steps_per_s": float(done.group(3)), "wall_s": wall, "iterations_per_step": per_step,
           "host_syncs": counts["host_syncs"], "host_syncs_per_step": counts["host_syncs"] / nsteps,
           "jacobian_actions": counts["jacobian_actions"], "linearisations": counts["linearisations"],
           "mass_drift": drift, "mass_drift_limit": drift_tol, "finite": True}
    if device != "cuda":
        return row, state
    if sw:
        launches = {k: counts[k] for k in ("sw_operator", "sw_state", "sw_tangent_prep", "sw_tangent_apply",
                                           "sw_plain_calls", "sw_plain_tangent_calls", "sw_pert", "sw_edges",
                                           "sw_halo")}
        want = dict(launches, sw_state=launches["sw_operator"], sw_tangent_apply=counts["jacobian_actions"],
                    sw_tangent_prep=counts["linearisations"], sw_plain_calls=0, sw_plain_tangent_calls=0,
                    sw_pert=0, sw_edges=0, sw_halo=0)
        operator = launches["sw_operator"]
    else:
        launches = {k: counts[k] for k in ("euler3d_operator", "euler3d_tangent", "euler3d_tangent_prep",
                                           "euler3d_plain_calls", "plain_tangent_calls", "euler3d_pert",
                                           "euler3d_pert_tangent")}
        want = dict(launches, euler3d_tangent=counts["jacobian_actions"],
                    euler3d_tangent_prep=counts["linearisations"], euler3d_plain_calls=0, plain_tangent_calls=0,
                    euler3d_pert=0, euler3d_pert_tangent=0)
        operator = launches["euler3d_operator"]
    if launches != want or operator == 0 or counts["jacobian_actions"] == 0 or counts["linearisations"] == 0:
        raise AssertionError(f"phase 36 {tag}: launches {launches}, expected {want} (Jacobian actions "
                             f"{counts['jacobian_actions']}, linearisations {counts['linearisations']})")
    row["launches"] = launches
    return row, state


def phase36(torch):
    """The paths of ROADMAP item 12 on the card: every exponential solver
    the port gained through EPI3, SRERK 3 and 6, the implicit, hybrid and
    GCROT paths on case 6, and SRERK, a low-synchronization EPI2, Crank-
    Nicolson and the exponential filter on dcmip31; then the nel = 10 paths
    on the CPU, within 1e-9 of scale with the same iterations a step."""
    import numpy as np

    t0 = time.perf_counter()
    rows, states = [], {}
    for run in ITEM12_RUNS:
        row, states[run[0]] = _item12_run(torch, run)
        rows.append(row)
    gpu_s = time.perf_counter() - t0
    cpu = {r[0]: _item12_run(torch, r, device="cpu") for r in ITEM12_RUNS if r[1] == "sw" and r[2] == 10}
    cpu_s = time.perf_counter() - t0 - gpu_s
    comparisons = []
    for row in rows:
        if row["tag"] not in cpu:
            continue
        crow, cstate = cpu[row["tag"]]
        nvar = cstate.shape[0]
        scale = np.abs(cstate).reshape(nvar, -1).max(axis=1).reshape((nvar,) + (1,) * (cstate.ndim - 1))
        err = float((np.abs(states[row["tag"]] - cstate) / scale).max())
        same = crow["iterations_per_step"] == row["iterations_per_step"]
        row["cpu"] = {"steps_per_s": crow["steps_per_s"], "iterations_per_step": crow["iterations_per_step"],
                      "jacobian_actions": crow["jacobian_actions"], "gpu_vs_cpu_err": err, "tol": 1e-9,
                      "same_iterations": same}
        comparisons.append((row["tag"], err, same, crow["jacobian_actions"] == row["jacobian_actions"]))
    emit({"phase": 36, "results": rows, "gpu_s": gpu_s, "cpu_s": cpu_s})
    bad = [c for c in comparisons if not (c[1] <= 1e-9 and c[2] and c[3])]
    if bad:
        raise AssertionError(f"phase 36: the card and the CPU differ (tag, err, same iterations, same Jacobian "
                             f"actions): {bad}")


# Phase 37: DCMIP 11 and 12, tracer advection under prescribed winds.
# (nel_h, nel_v, s) of the kernel checks against the plain version; the
# main path's width (DCMIP 2012 test 1-1's ~1 degree grid: 30x30 elements
# of 3 points a panel, 60 levels) is checked on the Simulation's own state.
ADVECTION_SHAPES = [(3, 2, 2), (4, 3, 3), (2, 2, 4), (2, 1, 5), (2, 2, 6), (7, 3, 3)]
ADVECTION_MAIN = (30, 20, 3)
# dt a case: the JAX package's wind overwrite writes w in m/s into the
# contravariant vertical slot, whose unit is the reference element, so
# |w| = 0.0148 (11) and 0.33 (12) a second there sets the explicit limit
# (near 25 s and 1.2 s), not the horizontal winds: 300 s halved four times,
# and nine times.
ADVECTION_DT = {11: 18.75, 12: 0.5859375}
# (tag, case, nel_h, nel_v, s, integrator, steps) of the paths through Simulation(ini).run().
ADVECTION_RUNS = [("b_dcmip11_tvdrk3", 11) + ADVECTION_MAIN + ("tvdrk3", 10),
                  ("c_dcmip12_tvdrk3", 12, 20, 10, 3, "tvdrk3", 10),
                  ("c_dcmip12_euler1", 12, 20, 10, 3, "euler1", 10)]
ADVECTION_CPU = (4, 3, 3, 10)  # (nel_h, nel_v, s, steps) of the card-against-CPU runs (d)
ADVECTION_INI = """
[General]
equations = euler
[System]
precision = float64
distribute = off
[Test_case]
case_number = {case}
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integrator}
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = {nel_h}
num_elements_vertical = {nel_v}
[Grid]
grid_type = cubed_sphere
ztop = 12000
[Output_options]
save_state_freq = 0
output_dir = {out}
"""
# The counters of the five-variable 3D kernels, which an advection path never launches.
FIVE_VARIABLE_COUNTERS = ("euler3d_operator", "euler3d_tangent", "euler3d_tangent_prep", "euler3d_pert",
                          "euler3d_pert_stage", "euler3d_pert_tangent", "euler3d_tile", "euler3d_pert_tile",
                          "euler3d_terrain", "euler3d_terrain_pert", "euler3d_terrain_tangent_prep",
                          "euler3d_terrain_tangent_apply")


def _advection_run(torch, tag, case, nel_h, nel_v, s, integrator, nsteps, device="cuda"):
    """One DCMIP 11/12 path through ``Simulation(ini).run()`` on ``device``:
    every integrator step and every wind overwrite inside
    ``forbid_uncounted_syncs`` on the card (the NaN guard's read is the
    step's counted sync), the state's rho and momenta kept on the card after
    each overwrite; then the gates: launches (one advection launch a stage;
    no plain call, no five-variable launch), each tracer's mass drift, rho
    and rho*theta unchanged to rounding, the momenta rho * the numpy winds
    at t + dt after every step. Returns (row, final state as numpy, sim)."""
    import numpy as np

    from wxfactory_tpu_torch.common.device import forbid_uncounted_syncs
    from wxfactory_tpu_torch.kernels.check import mass_weights
    from wxfactory_tpu_torch.simulation import Simulation
    from wxfactory_tpu_torch.testcases import dcmip_T11_update_winds, dcmip_T12_update_winds

    dt = ADVECTION_DT[case]
    out_dir = WORK / f"advection_{tag}_{device}"
    out_dir.mkdir(parents=True, exist_ok=True)
    ini = WORK / f"advection_{tag}_{device}.ini"
    ini.write_text(ADVECTION_INI.format(case=case, dt=dt, t_end=dt * nsteps, integrator=integrator, s=s,
                                        nel_h=nel_h, nel_v=nel_v, out=out_dir))
    log = io.StringIO()
    momenta = []
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        sim = Simulation(str(ini), device=device)
        setup = time.perf_counter() - t0
        plain_step, hook = sim.integrator.step, sim.post_step_hook

        def step(q, step_dt):
            with forbid_uncounted_syncs():
                return plain_step(q, step_dt)

        def overwrite(q, t):
            with forbid_uncounted_syncs():
                q = hook(q, t)
                momenta.append((t, q[0:4].clone()))
            return q

        sim.integrator.step, sim.post_step_hook = step, overwrite
        q = sim.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = log.getvalue()
    done = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    if done is None or int(done.group(1)) != nsteps:
        sys.stderr.write(text[-3000:])
        raise AssertionError(f"phase 37 {tag} on {device} did not complete {nsteps} steps")
    state, q0 = q.cpu().numpy(), sim.initial_q.cpu().numpy()
    wsg = mass_weights(sim.ops, sim.rhs.con).cpu().numpy()
    drift = [float(((wsg * state[r]).sum() - (wsg * q0[r]).sum()) / (wsg * q0[r]).sum())
             for r in range(5, state.shape[0])]
    eps = np.finfo(np.float64).eps
    unchanged = {name: float(np.abs(state[r] - q0[r]).max() / np.abs(q0[r]).max() / eps)
                 for name, r in (("rho", 0), ("rho_theta", 4))}
    winds = dcmip_T11_update_winds if case == 11 else dcmip_T12_update_winds
    wind_err = 0.0
    for t, rows in momenta:
        rows = rows.cpu().numpy()
        want = rows[0] * np.stack(winds(sim.geom, t))
        scale = np.abs(want).reshape(3, -1).max(axis=1).reshape(3, *([1] * (want.ndim - 1)))
        wind_err = max(wind_err, float((np.abs(rows[1:4] - want) / scale).max()))
    mix = lambda a: [[float((a[r] / a[0]).min()), float((a[r] / a[0]).max())] for r in range(5, a.shape[0])]
    row = {"tag": tag, "device": device, "case": case, "nel_h": nel_h, "nel_v": nel_v, "s": s,
           "points": 6 * nel_h * nel_h * nel_v * s**3, "tracers": state.shape[0] - 5, "integrator": integrator,
           "dt": dt, "steps": nsteps, "setup_s": setup, "run_s": float(done.group(2)),
           "steps_per_s": float(done.group(3)), "wall_s": wall, "host_syncs": counts["host_syncs"],
           "host_syncs_per_step": counts["host_syncs"] / nsteps, "tracer_mass_drift": drift,
           "unchanged_ulps": unchanged, "wind_err": wind_err, "overwrites": len(momenta),
           "finite": bool(np.isfinite(state).all()), "mixing_ratio_initial": mix(q0), "mixing_ratio_final": mix(state)}
    gates = {"finite": row["finite"], "tracer_mass": max(abs(d) for d in drift) <= 1e-12,
             "unchanged": max(unchanged.values()) <= 32.0, "winds": wind_err <= 1e-13,
             "overwrites": len(momenta) == nsteps}
    if device == "cuda":
        per_step = 3 if integrator == "tvdrk3" else 1
        launches = {k: counts[k] for k in ("euler3d_advection", "euler3d_plain_calls") + FIVE_VARIABLE_COUNTERS}
        row["launches"] = launches
        gates["launches"] = launches == dict({k: 0 for k in launches}, euler3d_advection=per_step * nsteps)
    row["gates"] = gates
    if not all(gates.values()):
        raise AssertionError(f"phase 37 {tag} on {device}: gates {gates}, row {row}")
    return row, state, sim


def _advection_timing(torch, smi, sim, state):
    """The card's time a call at the main path's width of the advection
    kernel (RHS, and stage + x + traces: the TVD-RK3 chain's call) and of
    its plain version, f64 on the run's state and f32 on the same cast,
    beside the bound, with the kernel checked against its plain version on
    those inputs (``compare_advection``) and its resources."""
    from wxfactory_tpu_torch.kernels.check import (advection_kernel_resources, compare_advection,
                                                   euler3d_advection_work)
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op

    nel_h, nel_v, s = ADVECTION_MAIN
    dt = ADVECTION_DT[11]
    con64 = sim.rhs.con
    y64, x64 = torch.as_tensor(state, device="cuda"), sim.initial_q
    rows, checks = [], []
    for dtype in (torch.float64, torch.float32):
        con = con64 if dtype == torch.float64 else e3op.build_constants(sim.ops, sim.metric, nel_h, nel_v,
                                                                        dtype=dtype, device="cuda")
        y, x = y64.to(dtype).contiguous(), x64.to(dtype).contiguous()
        checks += compare_advection(con, con64, sim.topology, sim.ops, x, y)
        halo = e3op.halo_from_traces(e3op.edge_traces(y, con), sim.topology)
        stage = dict(x=x, a=1.0 / 3.0, b=2.0 / 3.0, cdt=(2.0 / 3.0) * dt, emit_traces=True)
        name = str(dtype).replace("torch.", "")
        row = {"dtype": name, "nel_h": nel_h, "nel_v": nel_v, "s": s, "tracers": y.shape[0] - 5, "gpu": smi,
               "resources": advection_kernel_resources(dtype, s, y.shape[0] - 5)}
        for mode, kw, work in (("rhs", {}, euler3d_advection_work(con, 4)),
                               ("stage_x_traces", stage,
                                euler3d_advection_work(con, 4, stage=True, use_x=True, traces=True))):
            t = _pair_ms(torch, lambda: e3op.euler3d_advection(y, halo, con, **kw),
                         lambda: e3op.euler3d_advection_plain(y, halo, con, **kw))
            b = _bound(work, name)
            row.update({f"{mode}_kernel_ms": t["kernel_ms"], f"{mode}_plain_ms": t["plain_ms"],
                        f"{mode}_kernel_event_ms": t["kernel_event_ms"], f"{mode}_bound_ms": b["bound_ms"],
                        f"{mode}_bound_by": b["bound_by"], f"{mode}_bytes": b["bytes"], f"{mode}_ops": b["ops"]})
        rows.append(row)
    return rows, checks


def phase37(torch, smi):
    """DCMIP 11 and 12 on the card: (a) the advection kernel against its
    plain version (RHS with rows 0-4 exactly 0, stage, stage + x, stage + x +
    traces; 1 and 4 tracers; f64 and f32; each tracer's mass) at
    ADVECTION_SHAPES and at the main path's width; (b) DCMIP 11 through
    Simulation(ini).run() at 30x30x20, s = 3, TVD-RK3, 10 steps; (c) DCMIP
    12 with TVD-RK3 and Euler1 at 20x20x10; (d) both cases at 4x3x3 on the
    card and on the CPU within 1e-12 of scale; the kernel's time beside its
    plain version's and its bound."""
    import numpy as np

    from wxfactory_tpu_torch.kernels.check import compare_euler3d_advection

    t0 = time.perf_counter()
    rows = []
    for shape in ADVECTION_SHAPES:
        for ntracer in (1, 4):
            for dtype in (torch.float64, torch.float32):
                rows += compare_euler3d_advection(*shape, ntracer, dtype, device="cuda")
    small_s = time.perf_counter() - t0
    runs, states = [], {}
    for run in ADVECTION_RUNS:
        row, states[run[0]], sim = _advection_run(torch, *run)
        runs.append(row)
        if run[0].startswith("b_"):
            timing, checks = _advection_timing(torch, smi, sim, states[run[0]])
            rows += checks
            launches = row["launches"]["euler3d_advection"]
        del sim
    emit_comparison(37, rows, ("nel_h", "nel_v", "s", "ntracer"))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"phase 37: the advection kernel disagrees with its plain version: {bad[:4]}")
    nel_h, nel_v, s, nsteps = ADVECTION_CPU
    cpu = []
    for case in (11, 12):
        tag = f"d_dcmip{case}_tvdrk3"
        got = _advection_run(torch, tag, case, nel_h, nel_v, s, "tvdrk3", nsteps)[1]
        crow, want, _ = _advection_run(torch, tag, case, nel_h, nel_v, s, "tvdrk3", nsteps, device="cpu")
        scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1).reshape(-1, *([1] * (want.ndim - 1)))
        cpu.append({"case": case, "nel_h": nel_h, "nel_v": nel_v, "s": s, "steps": nsteps,
                    "err": float((np.abs(got - want) / scale).max()), "tol": 1e-12})
    emit({"phase": 37, "runs": runs, "timing": timing, "cpu": cpu, "checks_s": small_s,
          "main_max_abs_err": max(r["max_abs_err"] for r in rows if (r["nel_h"], r["nel_v"], r["s"]) == ADVECTION_MAIN
                                  and r["dtype"] == "float64")})
    if not all(c["err"] <= c["tol"] for c in cpu):
        raise AssertionError(f"phase 37: the card and the CPU differ: {cpu}")
    main_err = max(r["max_abs_err"] for r in rows
                   if (r["nel_h"], r["nel_v"], r["s"]) == ADVECTION_MAIN and r["dtype"] == "float64")
    return {"launches": launches, "max_abs_err": main_err, "timing": timing[0]}


# Phase 38: the 2D Cartesian Euler model (DFR and FV kernels and their
# tangents). (nel_x, nel_z, s, case) of the kernel checks against the plain
# versions; the main width is checked on the Simulation's own state.
CARTESIAN_SHAPES = [(4, 3, 2, 2), (3, 2, 3, 4), (4, 3, 4, 2), (2, 2, 5, 4), (2, 1, 6, 2), (10, 15, 4, 2)]
# (ncell_x, ncell_z) of the FV checks: a small grid and the fv-mg levels of path (c).
CARTESIAN_FV_GRIDS = [(9, 7), (40, 60), (20, 30)]
# The cold density current (Straka et al. 1993) on the symmetric half [0,
# 25.6 km] x [0, 6.4 km] at 100 m elements, s = 4: 262,144 points.
CARTESIAN_MAIN = (256, 64, 4)
# (tag, case, nel_x, nel_z, s, integrator, dt, steps, preconditioner, mg levels)
CARTESIAN_RUNS = [("a_case4_tvdrk3", 4) + CARTESIAN_MAIN + ("tvdrk3", 0.02, 20, "none", 3),
                  ("b_case4_epi2", 4) + CARTESIAN_MAIN + ("epi2", 1.0, 3, "none", 3),
                  ("c_case2_ros2", 2, 10, 15, 4, "ros2", 1.0, 2, "none", 3),
                  ("c_case2_ros2_pmg", 2, 10, 15, 4, "ros2", 1.0, 2, "p-mg", 3),
                  ("c_case2_ros2_fvmg", 2, 10, 15, 4, "ros2", 1.0, 2, "fv-mg", 3)]
# The card against the CPU (the plain versions): (tag, integrator, dt, steps) on case 2 at 5 x 7, s = 4.
CARTESIAN_CPU = [("d_case2_tvdrk3", "tvdrk3", 0.02, 10), ("d_case2_epi2", "epi2", 1.0, 2)]
# (ncell_x, ncell_z) at which the FV kernels are timed: fv-mg's first FV
# level on path (c) (10 x 15 elements of s = 4).
CARTESIAN_FV_TIMED = (40, 60)
CARTESIAN_INI = """
[General]
equations = euler
[System]
precision = float64
distribute = off
[Grid]
grid_type = cartesian2d
x0 = 0
x1 = {x1}
z0 = 0
z1 = {z1}
[Test_case]
case_number = {case}
bubble_theta = {theta}
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = kiops
tolerance = 1e-7
verbose_solver = 1
[Preconditioning]
preconditioner = {pre}
num_mg_levels = {levels}
pseudo_cfl = 3.0
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = {nel_x}
num_elements_vertical = {nel_z}
[Output_options]
save_state_freq = 0
output_dir = {out}
"""
CARTESIAN_COUNTERS = ("euler_cartesian", "euler_cartesian_tangent", "euler_cartesian_fv",
                      "euler_cartesian_fv_tangent", "euler_cartesian_plain_calls",
                      "euler_cartesian_plain_tangent_calls")
KRYLOV_ITS = re.compile(r"(kiops converged|convergence|stagnation) at iteration (\d+)")


def _cartesian_mass(q, ops):
    """The Gauss-Legendre weighted integrals of rho and rho*theta, float64."""
    import numpy as np

    w = np.outer(ops.weights, ops.weights).reshape(-1)
    return [float((w * q[r]).sum()) for r in (0, 3)]


def _cartesian_run(torch, tag, case, nel_x, nel_z, s, integrator, dt, nsteps, pre, levels, device="cuda"):
    """One Cartesian path through ``Simulation(ini).run()`` on ``device``:
    every integrator step inside ``forbid_uncounted_syncs`` on the card; the
    gates: only the Cartesian kernels launch (the DFR operator on every RHS
    and stage, its tangent once a Jacobian action of the integrator, the
    multigrid levels' A.v on their DFR or FV tangent), no plain call, a
    finite state, the rho and rho*theta integrals conserved. Returns (row,
    final state as numpy, sim)."""
    import numpy as np

    from wxfactory_tpu_torch.common.device import forbid_uncounted_syncs
    from wxfactory_tpu_torch.kernels.check import CARTESIAN_DOMAINS, CARTESIAN_THETA
    from wxfactory_tpu_torch.simulation import Simulation

    (_, x1), (_, z1) = CARTESIAN_DOMAINS[case]
    out_dir = WORK / f"cartesian_{tag}_{device}"
    out_dir.mkdir(parents=True, exist_ok=True)
    ini = WORK / f"cartesian_{tag}_{device}.ini"
    ini.write_text(CARTESIAN_INI.format(x1=x1, z1=z1, case=case, theta=CARTESIAN_THETA[case], dt=dt,
                                        t_end=dt * nsteps, integrator=integrator, pre=pre, levels=levels, s=s,
                                        nel_x=nel_x, nel_z=nel_z, out=out_dir))
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        sim = Simulation(str(ini), device=device)
        setup = time.perf_counter() - t0
        plain_step = sim.integrator.step

        def step(q, step_dt):
            with forbid_uncounted_syncs():
                return plain_step(q, step_dt)

        sim.integrator.step = step
        q = sim.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = log.getvalue()
    done = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    if done is None or int(done.group(1)) != nsteps:
        sys.stderr.write(text[-3000:])
        raise AssertionError(f"phase 38 {tag} on {device} did not complete {nsteps} steps")
    state, q0 = q.cpu().numpy(), sim.initial_q.cpu().numpy()
    m, m0 = _cartesian_mass(state, sim.ops), _cartesian_mass(q0, sim.ops)
    drift = [(a - b) / b for a, b in zip(m, m0)]
    its = [(k, int(n)) for k, n in KRYLOV_ITS.findall(text)]
    row = {"tag": tag, "device": device, "case": case, "nel_x": nel_x, "nel_z": nel_z, "s": s,
           "points": nel_x * nel_z * s * s, "integrator": integrator, "preconditioner": pre, "dt": dt,
           "steps": nsteps, "setup_s": setup, "run_s": float(done.group(2)), "steps_per_s": float(done.group(3)),
           "wall_s": wall, "host_syncs": counts["host_syncs"], "host_syncs_per_step": counts["host_syncs"] / nsteps,
           "krylov": its, "jacobian_actions": counts["jacobian_actions"], "mass_drift": drift,
           "finite": bool(np.isfinite(state).all()), "max_w": float(np.abs(state[2] / state[0]).max()),
           "min_theta": float((state[3] / state[0]).min())}
    # TVD-RK3 conserves the integrals to round-off; the Krylov paths to
    # their solves' rounding (each J.v conserves them too).
    drift_tol = 1e-12 if integrator == "tvdrk3" else 1e-9
    gates = {"finite": row["finite"], "mass": max(abs(d) for d in drift) <= drift_tol}
    if device == "cuda":
        mg = sim.integrator.preconditioner
        applies = sum(lv.applies for lv in mg.levels) if mg is not None else 0
        fv_applies = sum(lv.applies for lv in mg.levels if lv.num_solpts == 1) if mg is not None else 0
        launches = {k: counts[k] for k in CARTESIAN_COUNTERS + ("sw_operator", "euler3d_operator",
                                                               "euler3d_tangent", "euler3d_advection")}
        row["launches"] = launches
        row["mg_applies"] = applies
        tangents = launches["euler_cartesian_tangent"] + launches["euler_cartesian_fv_tangent"]
        gates["launches"] = (
            launches["euler_cartesian"] > 0
            and (launches["euler_cartesian"] == 3 * nsteps if integrator == "tvdrk3" else True)
            and tangents == counts["jacobian_actions"] + applies
            and launches["euler_cartesian_fv_tangent"] == fv_applies
            and (tangents > 0 if integrator != "tvdrk3" else tangents == 0)
            and all(launches[k] == 0 for k in ("euler_cartesian_fv", "euler_cartesian_plain_calls",
                                               "euler_cartesian_plain_tangent_calls", "sw_operator",
                                               "euler3d_operator", "euler3d_tangent", "euler3d_advection")))
    row["gates"] = gates
    if not all(gates.values()):
        raise AssertionError(f"phase 38 {tag} on {device}: gates {gates}, row {row}")
    return row, state, sim


def _cartesian_card_cpu(torch):
    """At 4 x 3 elements, s = 4 (case 4): each kernel on the card against its
    plain version on the CPU on the same inputs, f64 within 1e-13 of each
    row's scale (the tangents 1e-12 of their max)."""
    from wxfactory_tpu_torch.kernels.check import (euler_cartesian_fv_inputs, euler_cartesian_inputs,
                                                   euler_cartesian_term_scale, per_variable_max)
    from wxfactory_tpu_torch.ops import euler_cartesian_operator as ecop

    ops, _, con_c, x, y, v, q0 = euler_cartesian_inputs(4, 3, 4, torch.float64, "cpu", case=4)
    _, _, con_g, *_ = euler_cartesian_inputs(4, 3, 4, torch.float64, "cuda", case=4)
    g = lambda t: t.cuda()
    scale = lambda want: torch.maximum(per_variable_max(want), euler_cartesian_term_scale(y, con_c))
    err = lambda got, want, sc: float((per_variable_max(got.cpu() - want) / sc).max())
    out = {}
    want = ecop.euler_cartesian_plain(y, con_c)
    out["rhs"] = err(ecop.euler_cartesian(g(y), con_g), want, scale(want))
    want = ecop.euler_cartesian_plain(y, con_c, x=x, a=0.75, b=0.25, cdt=0.005)
    out["stage_x"] = err(ecop.euler_cartesian(g(y), con_g, x=g(x), a=0.75, b=0.25, cdt=0.005), want,
                         torch.maximum(per_variable_max(want), 0.005 * euler_cartesian_term_scale(y, con_c)))
    for name, q in (("tangent", y), ("tangent_rest", q0)):
        want = ecop.euler_cartesian_tangent_plain(q, v, con_c)
        out[name] = err(ecop.euler_cartesian_tangent(g(q), g(v), con_g), want, per_variable_max(want))
    con64c, _, yf, vf, q0f = euler_cartesian_fv_inputs(16, 12, "ausm", torch.float64, "cpu", case=4)
    _, con_fg, *_ = euler_cartesian_fv_inputs(16, 12, "ausm", torch.float64, "cuda", case=4)
    want = ecop.euler_cartesian_fv_plain(yf, con64c)
    out["fv_rhs"] = err(ecop.euler_cartesian_fv(g(yf), con_fg), want, per_variable_max(want))
    want = ecop.euler_cartesian_fv_tangent_plain(yf, vf, con64c)
    out["fv_tangent"] = err(ecop.euler_cartesian_fv_tangent(g(yf), g(vf), con_fg), want, per_variable_max(want))
    ok = all(e <= (1e-12 if "tangent" in k else 1e-13) for k, e in out.items())
    return {"nel_x": 4, "nel_z": 3, "s": 4, "fv_cells": [16, 12], "err": out, "ok": ok}


def _cartesian_timing(torch, smi, sim, state):
    """The card's time a call, f64 and f32, of the DFR kernel (RHS, and the
    stage with x, the TVD-RK3 chain's call) and its tangent at the main
    path's width on the run's state (f32 on the same cast), and of the FV
    kernel's RHS and its tangent at CARTESIAN_FV_TIMED cells (fv-mg's first
    FV level on path (c)), each beside its plain version and its bound,
    with the kernels' resources; and the DFR kernels held against their
    plain versions on the main path's inputs (``compare_cartesian``)."""
    import numpy as np

    from wxfactory_tpu_torch.geometry import make_cartesian_2d
    from wxfactory_tpu_torch.kernels.check import (cartesian_direction, compare_cartesian, euler_cartesian_fv_work,
                                                   euler_cartesian_kernel_resources, euler_cartesian_work,
                                                   perturbed_cartesian)
    from wxfactory_tpu_torch.ops import euler_cartesian_operator as ecop
    from wxfactory_tpu_torch.testcases import initialize_cartesian2d

    nel_x, nel_z, s = CARTESIAN_MAIN
    dt = 0.02
    rng = np.random.default_rng(0)
    v64 = torch.as_tensor(cartesian_direction(state, rng), device="cuda")
    y64, x64 = torch.as_tensor(state, device="cuda"), sim.initial_q
    ncx, ncz = CARTESIAN_FV_TIMED
    fgeom = make_cartesian_2d((0.0, 1000.0), (0.0, 1500.0), ncx, ncz, 1)
    fq = perturbed_cartesian(initialize_cartesian2d(fgeom, 2)[..., 0], rng)
    fy64 = torch.as_tensor(fq, device="cuda")
    fv64 = torch.as_tensor(cartesian_direction(fq, rng), device="cuda")
    rows, checks = [], []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).replace("torch.", "")
        con = ecop.build_constants(sim.geom, sim.ops, dtype=dtype, device="cuda")
        y, x, v = (t.to(dtype).contiguous() for t in (y64, x64, v64))
        checks += compare_cartesian(con, sim.rhs.con, sim.ops, x, y, v, x)
        fcon = ecop.build_fv_constants(fgeom, "ausm", dtype=dtype, device="cuda")
        fy, fv = (t.to(dtype).contiguous() for t in (fy64, fv64))
        stage = dict(x=x, a=1.0 / 3.0, b=2.0 / 3.0, cdt=(2.0 / 3.0) * dt)
        row = {"dtype": name, "nel_x": nel_x, "nel_z": nel_z, "s": s, "fv_cells": [ncx, ncz], "gpu": smi,
               "resources": euler_cartesian_kernel_resources(dtype, s)}
        for mode, kernel, plain, work in (
                ("rhs", lambda: ecop.euler_cartesian(y, con), lambda: ecop.euler_cartesian_plain(y, con),
                 euler_cartesian_work(con)),
                ("stage_x", lambda: ecop.euler_cartesian(y, con, **stage),
                 lambda: ecop.euler_cartesian_plain(y, con, **stage),
                 euler_cartesian_work(con, stage=True, use_x=True)),
                ("tangent", lambda: ecop.euler_cartesian_tangent(y, v, con),
                 lambda: ecop.euler_cartesian_tangent_plain(y, v, con), euler_cartesian_work(con, tangent=True)),
                ("fv_rhs", lambda: ecop.euler_cartesian_fv(fy, fcon), lambda: ecop.euler_cartesian_fv_plain(fy, fcon),
                 euler_cartesian_fv_work(fcon)),
                ("fv_tangent", lambda: ecop.euler_cartesian_fv_tangent(fy, fv, fcon),
                 lambda: ecop.euler_cartesian_fv_tangent_plain(fy, fv, fcon),
                 euler_cartesian_fv_work(fcon, tangent=True))):
            t = _pair_ms(torch, kernel, plain)
            b = _bound(work, name)
            row.update({f"{mode}_kernel_ms": t["kernel_ms"], f"{mode}_plain_ms": t["plain_ms"],
                        f"{mode}_kernel_event_ms": t["kernel_event_ms"], f"{mode}_bound_ms": b["bound_ms"],
                        f"{mode}_bound_by": b["bound_by"], f"{mode}_bytes": b["bytes"], f"{mode}_ops": b["ops"]})
        rows.append(row)
    return rows, checks


def phase38(torch, smi):
    """The 2D Cartesian Euler model on the card: (1) the four kernels against
    their plain versions at CARTESIAN_SHAPES (cases 2 and 4) and
    CARTESIAN_FV_GRIDS (every flux), f64 and f32, the tangents also at rest
    (the ties), every RHS holding mass, and on the main path's own state;
    each kernel on the card against its plain version on the CPU at 4 x 3;
    (2) the paths through Simulation(ini).run(): (a) case 4 at 256 x 64, s
    = 4, TVD-RK3, dt = 0.02 s, 20 steps (three DFR launches a step); (b) the
    same with EPI2 + KIOPS, dt = 1 s, 3 steps (one tangent launch a J.v);
    (c) case 2 at 10 x 15, s = 4, Ros2 + FGMRES, dt = 1 s, 2 steps, without
    a preconditioner, with p-mg (3 levels) and with fv-mg (3 levels: the
    FV tangent on its coarse levels), none launching the FV RHS kernel; (d)
    case 2 at 5 x 7 on the card and on the CPU within 1e-12 (TVD-RK3) and
    1e-10 (EPI2, the same Krylov counts); the kernels' times beside their
    plain versions and bounds."""
    import numpy as np

    from wxfactory_tpu_torch.kernels.check import compare_euler_cartesian, compare_euler_cartesian_fv

    t0 = time.perf_counter()
    rows = []
    for nx, nz, s, case in CARTESIAN_SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows += compare_euler_cartesian(nx, nz, s, dtype, device="cuda", case=case)
    fv_rows = []
    for ncx, ncz in CARTESIAN_FV_GRIDS:
        for flux in ("ausm", "rusanov", "upwind"):
            for dtype in (torch.float64, torch.float32):
                fv_rows += compare_euler_cartesian_fv(ncx, ncz, flux, dtype, device="cuda")
    card_cpu = _cartesian_card_cpu(torch)
    checks_s = time.perf_counter() - t0
    runs, states, sims = [], {}, {}
    for run in CARTESIAN_RUNS:
        row, states[run[0]], sim = _cartesian_run(torch, *run)
        runs.append(row)
        if run[0].startswith("a_"):
            timing, main_checks = _cartesian_timing(torch, smi, sim, states[run[0]])
            rows += main_checks
        del sim
    cpu = []
    for tag, integrator, dt, nsteps in CARTESIAN_CPU:
        grow, got, _ = _cartesian_run(torch, tag, 2, 5, 7, 4, integrator, dt, nsteps, "none", 3)
        crow, want, _ = _cartesian_run(torch, tag, 2, 5, 7, 4, integrator, dt, nsteps, "none", 3, device="cpu")
        scale = np.abs(want).reshape(4, -1).max(axis=1)
        scale[1:3] = np.maximum(scale[1:3], np.abs(want[0]).max())  # the momenta in units of rho_max m/s
        tol = 1e-12 if integrator == "tvdrk3" else 1e-10
        cpu.append({"tag": tag, "integrator": integrator, "steps": nsteps, "tol": tol,
                    "err": float((np.abs(got - want) / scale.reshape(4, 1, 1, 1)).max()),
                    "krylov_card": grow["krylov"], "krylov_cpu": crow["krylov"]})
    emit_comparison(38, rows, ("nel_x", "nel_z", "s"))
    emit_comparison(38, fv_rows, ("ncell_x", "ncell_z", "flux"), tag="_fv")
    bad = [r for r in rows + fv_rows if not r["ok"]]
    if bad or not card_cpu["ok"]:
        raise AssertionError(f"phase 38: a Cartesian kernel disagrees with its plain version: {bad[:4]} "
                             f"card/cpu {card_cpu}")
    fv_err = lambda mode: max(r["max_abs_err"] for r in fv_rows if (r["ncell_x"], r["ncell_z"]) == CARTESIAN_FV_TIMED
                              and r["dtype"] == "float64" and r["mode"] in mode)
    # The FV RHS kernel: held and timed, launched by no path (the multigrid
    # levels take only J.v), so it stays out of the kernels line.
    unlaunched = {"euler_cartesian_fv": {
        "launches": sum(r["launches"]["euler_cartesian_fv"] for r in runs), "max_abs_err": fv_err(("rhs",)),
        **{k: timing[0][f"fv_rhs_{k}"] for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by")}}}
    emit({"phase": 38, "runs": runs, "timing": timing, "cpu": cpu, "card_cpu": card_cpu, "checks_s": checks_s,
          "unlaunched": unlaunched})
    if not all(c["err"] <= c["tol"] and c["krylov_card"] == c["krylov_cpu"] for c in cpu):
        raise AssertionError(f"phase 38: the card and the CPU differ: {cpu}")
    by_tag = {r["tag"]: r for r in runs}
    main = lambda mode: max(r["max_abs_err"] for r in rows if (r["nel_x"], r["nel_z"], r["s"]) == CARTESIAN_MAIN[:3]
                            and r["dtype"] == "float64" and r["mode"] in mode)
    tangent_launches = sum(by_tag[t]["launches"]["euler_cartesian_tangent"] for t in by_tag if t[0] in "bc")
    return {"launches": {"euler_cartesian": by_tag["a_case4_tvdrk3"]["launches"]["euler_cartesian"],
                         "euler_cartesian_tangent": tangent_launches,
                         "euler_cartesian_fv_tangent": by_tag["c_case2_ros2_fvmg"]["launches"]
                         ["euler_cartesian_fv_tangent"]},
            "max_abs_err": {"euler_cartesian": main(("rhs", "stage", "stage_x")),
                            "euler_cartesian_tangent": main(("tangent", "tangent_rest")),
                            "euler_cartesian_fv_tangent": fv_err(("tangent", "tangent_rest"))},
            "timing": timing[0]}


# Phase 39: the Jacobian action of the DCMIP 11/12 advection and the
# implicit, exponential and Rosenbrock integrators on those cases.
ADVECTION_TANGENT_INI = """
[General]
equations = euler
[System]
precision = float64
distribute = off
[Test_case]
case_number = {case}
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = {solver}
linear_solver = fgmres
tolerance = 1e-7
[Preconditioning]
preconditioner = {pre}
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = {nel_h}
num_elements_vertical = {nel_v}
[Grid]
grid_type = cubed_sphere
ztop = 12000
[Output_options]
save_state_freq = 0
output_dir = {out}
"""
# (tag, case, nel_h, nel_v, s, integrator, exponential solver, preconditioner, steps) of paths (b) and (d).
ADVECTION_TANGENT_MAIN = ("b_dcmip11_epi2_kiops", 11) + ADVECTION_MAIN + ("epi2", "kiops", "none", 3)
ADVECTION_TANGENT_RUNS = [("d_dcmip12_ros2", 12, 20, 10, 3, "ros2", "kiops", "none", 2),
                          ("d_dcmip12_crank_nicolson", 12, 20, 10, 3, "crank_nicolson", "kiops", "none", 2),
                          ("d_dcmip12_ros2_lu", 12, 3, 2, 2, "ros2", "kiops", "lu", 1)]
# (tag, case, integrator, tolerance) of the card-against-CPU runs (e) at ADVECTION_CPU's shape, 2 steps.
ADVECTION_TANGENT_CPU = [("e_dcmip11_epi2", 11, "epi2", 1e-12), ("e_dcmip12_ros2", 12, "ros2", 1e-10),
                         ("e_dcmip12_crank_nicolson", 12, "crank_nicolson", 1e-10)]


def _advection_tangent_run(torch, run, device="cuda", sim=None):
    """One DCMIP 11/12 path of phase 39 through ``Simulation(ini).run()`` on
    ``device`` (``sim``: a Simulation to run again, its integrator already
    set): every integrator step inside ``forbid_uncounted_syncs`` on the
    card without a preconditioner (lu's dense Jacobian comes to the host),
    the iterations a step; on the card the launch gates (one tangent apply
    a Jacobian action, or a probed column of lu's Jacobian, one prep a
    linearisation, advection RHS launches, no plain call, no five-variable
    launch); a finite state, the momenta rho * the winds at t_end, each
    tracer's mass drift. Returns (row, final state as numpy, sim)."""
    import numpy as np

    from wxfactory_tpu_torch.common.device import forbid_uncounted_syncs
    from wxfactory_tpu_torch.kernels.check import mass_weights
    from wxfactory_tpu_torch.simulation import Simulation
    from wxfactory_tpu_torch.testcases import dcmip_T11_update_winds, dcmip_T12_update_winds

    tag, case, nel_h, nel_v, s, integrator, solver, pre, nsteps = run
    dt = ADVECTION_DT[case]
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        if sim is None:
            out_dir = WORK / f"advection_tangent_{tag}_{device}"
            out_dir.mkdir(parents=True, exist_ok=True)
            ini = WORK / f"advection_tangent_{tag}_{device}.ini"
            ini.write_text(ADVECTION_TANGENT_INI.format(case=case, dt=dt, t_end=dt * nsteps, integrator=integrator,
                                                        solver=solver, pre=pre, s=s, nel_h=nel_h, nel_v=nel_v,
                                                        out=out_dir))
            sim = Simulation(str(ini), device=device)
        setup = time.perf_counter() - t0
        integ, per_step = sim.integrator, []
        plain_step = integ.step

        def step(q, step_dt):
            if device == "cuda" and pre == "none":
                with forbid_uncounted_syncs():
                    q = plain_step(q, step_dt)
            else:
                q = plain_step(q, step_dt)
            per_step.append(int(integ.solver_info.total_num_it))
            return q

        integ.step = step
        reset_counts()
        q = sim.run()
        integ.step = plain_step
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = log.getvalue()
    done = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    if done is None or int(done.group(1)) != nsteps:
        sys.stderr.write(text[-3000:])
        raise AssertionError(f"phase 39 {tag} on {device} did not complete {nsteps} steps")
    state, q0 = q.cpu().numpy(), sim.initial_q.cpu().numpy()
    wsg = mass_weights(sim.ops, sim.rhs.con).cpu().numpy()
    drift = [float(((wsg * state[r]).sum() - (wsg * q0[r]).sum()) / (wsg * q0[r]).sum())
             for r in range(5, state.shape[0])]
    winds = np.stack((dcmip_T11_update_winds if case == 11 else dcmip_T12_update_winds)(sim.geom, dt * nsteps))
    want = state[0] * winds
    scale = np.abs(want).reshape(3, -1).max(axis=1).reshape(3, *([1] * (want.ndim - 1)))
    wind_err = float((np.abs(state[1:4] - want) / scale).max())
    row = {"tag": tag, "device": device, "case": case, "nel_h": nel_h, "nel_v": nel_v, "s": s,
           "points": 6 * nel_h * nel_h * nel_v * s**3, "tracers": state.shape[0] - 5, "integrator": integrator,
           "exponential_solver": solver if integrator.startswith("epi") else None, "preconditioner": pre, "dt": dt,
           "steps": nsteps, "setup_s": setup, "run_s": float(done.group(2)), "steps_per_s": float(done.group(3)),
           "wall_s": wall, "iterations_per_step": per_step, "host_syncs": counts["host_syncs"],
           "host_syncs_per_step": counts["host_syncs"] / nsteps, "jacobian_actions": counts["jacobian_actions"],
           "linearisations": counts["linearisations"], "tracer_mass_drift": drift, "wind_err": wind_err,
           "finite": bool(np.isfinite(state).all())}
    gates = {"finite": row["finite"], "tracer_mass": max(abs(d) for d in drift) <= 1e-12, "winds": wind_err <= 1e-13}
    if device == "cuda":
        keys = ("euler3d_advection", "euler3d_advection_tangent_prep", "euler3d_advection_tangent_apply",
                "euler3d_plain_calls", "plain_tangent_calls") + FIVE_VARIABLE_COUNTERS
        launches = {k: counts[k] for k in keys}
        # lu probes its dense Jacobian one tangent apply a column, outside the matvec closures.
        probes = int(q0.size) * nsteps if pre == "lu" else 0  # one factorisation a step
        want_launches = dict({k: 0 for k in keys}, euler3d_advection=launches["euler3d_advection"],
                             euler3d_advection_tangent_prep=counts["linearisations"],
                             euler3d_advection_tangent_apply=counts["jacobian_actions"] + probes)
        row["launches"] = launches
        gates["launches"] = (launches == want_launches and launches["euler3d_advection"] > 0
                             and counts["jacobian_actions"] > 0)
    if pre == "lu":
        gates["one_iteration_a_step"] = per_step == [1] * nsteps
    row["gates"] = gates
    if not all(gates.values()):
        raise AssertionError(f"phase 39 {tag} on {device}: gates {gates}, row {row}")
    return row, state, sim


def _advection_tangent_timing(torch, smi, sim, state):
    """The card's time a call of the prep and of the apply at the main
    path's width, 4 tracers, f64 on path (b)'s final state and f32 on its
    cast, in a direction with every row set, beside their plain versions,
    the function's bound, each kernel's own floor and its resources; with
    the kernels checked against the plain pair on those inputs
    (``compare_advection_tangent``)."""
    from wxfactory_tpu_torch.kernels.check import (advection_direction, advection_tangent_kernel_resources,
                                                   compare_advection_tangent, euler3d_advection_tangent_apply_work,
                                                   euler3d_advection_tangent_prep_work,
                                                   euler3d_advection_tangent_work, tangent_halos)
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op

    nel_h, nel_v, s = ADVECTION_MAIN
    con64 = sim.rhs.con
    q64 = torch.as_tensor(state, device="cuda")
    v64 = advection_direction(q64)
    rows, checks = [], []
    for dtype in (torch.float64, torch.float32):
        con = con64 if dtype == torch.float64 else e3op.build_constants(sim.ops, sim.metric, nel_h, nel_v,
                                                                        dtype=dtype, device="cuda")
        q, v = q64.to(dtype).contiguous(), v64.to(dtype).contiguous()
        checks += compare_advection_tangent(con, con64, sim.topology, sim.ops, q, v)
        nt = q.shape[0] - 5
        halo_q, halo_v = tangent_halos(q, v, con, sim.topology)
        coef = e3op.euler3d_advection_tangent_prep(q, halo_q, con)
        name = str(dtype).replace("torch.", "")
        row = {"dtype": name, "nel_h": nel_h, "nel_v": nel_v, "s": s, "tracers": nt, "gpu": smi,
               "resources": advection_tangent_kernel_resources(dtype, s, nt)}
        pairs = {"prep": (lambda: e3op.euler3d_advection_tangent_prep(q, halo_q, con),
                          lambda: e3op.euler3d_advection_tangent_prep_plain(q, halo_q, con)),
                 "apply": (lambda: e3op.euler3d_advection_tangent_apply(v, halo_v, coef, con),
                           lambda: e3op.euler3d_advection_tangent_apply_plain(v, halo_v, coef, con))}
        for kernel, (fn, plain) in pairs.items():
            t = _pair_ms(torch, fn, plain)
            row.update({f"{kernel}_kernel_ms": t["kernel_ms"], f"{kernel}_plain_ms": t["plain_ms"],
                        f"{kernel}_kernel_event_ms": t["kernel_event_ms"]})
        for what, work in (("function", euler3d_advection_tangent_work(con, nt)),
                           ("prep_own", euler3d_advection_tangent_prep_work(con, nt)),
                           ("apply_own", euler3d_advection_tangent_apply_work(con, nt))):
            b = _bound(work, name)
            row.update({f"{what}_bound_ms": b["bound_ms"], f"{what}_bound_by": b["bound_by"],
                        f"{what}_bytes": b["bytes"], f"{what}_ops": b["ops"]})
        rows.append(row)
    return rows, checks


def phase39(torch, smi):
    """The Jacobian action of the DCMIP 11/12 tracer advection on the card
    (the module docstring's item 39): (a) the kernels against the plain
    pair, (b) DCMIP 11 EPI2 + KIOPS at the main width, (c) the same with
    kiops_jit, (d) DCMIP 12 Ros2, Crank-Nicolson and Ros2 + lu, (e) card
    against CPU, (f) the kernels' times."""
    import numpy as np

    from wxfactory_tpu_torch.kernels.check import compare_euler3d_advection_tangent
    from wxfactory_tpu_torch.profile import profile_simulation

    t0 = time.perf_counter()
    rows = []
    for shape in ADVECTION_SHAPES:
        for ntracer in (1, 4):
            for dtype in (torch.float64, torch.float32):
                rows += compare_euler3d_advection_tangent(*shape, ntracer, dtype, device="cuda")
    checks_s = time.perf_counter() - t0
    main, state, sim = _advection_tangent_run(torch, ADVECTION_TANGENT_MAIN)
    with contextlib.redirect_stdout(io.StringIO()):
        prof = profile_simulation(sim, steps=2, warmup=0)
    main.update(device_busy_share=prof["device_busy_share"], profiled_step_ms=prof["profiled_step_ms"],
                profile_kernels_us_per_step=prof["kernels_us_per_step"][:6])
    timing, main_checks = _advection_tangent_timing(torch, smi, sim, state)
    rows += main_checks
    # (c) kiops_jit on (b)'s Simulation (its geometry and metric).
    sim.config.exponential_solver = "kiops_jit"
    sim.integrator = sim._create_integrator()
    jit_run = ("c_dcmip11_epi2_kiops_jit",) + ADVECTION_TANGENT_MAIN[1:6] + ("kiops_jit",) + ADVECTION_TANGENT_MAIN[7:]
    jit_row = _advection_tangent_run(torch, jit_run, sim=sim)[0]
    del sim
    runs = [main, jit_row] + [_advection_tangent_run(torch, run)[0] for run in ADVECTION_TANGENT_RUNS]
    nel_h, nel_v, s, _ = ADVECTION_CPU
    cpu = []
    for tag, case, integrator, tol in ADVECTION_TANGENT_CPU:
        run = (tag, case, nel_h, nel_v, s, integrator, "kiops", "none", 2)
        grow, got, _ = _advection_tangent_run(torch, run)
        crow, want, _ = _advection_tangent_run(torch, run, device="cpu")
        scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1).reshape(-1, *([1] * (want.ndim - 1)))
        cpu.append({"tag": tag, "err": float((np.abs(got - want) / scale).max()), "tol": tol,
                    "iterations_card": grow["iterations_per_step"], "iterations_cpu": crow["iterations_per_step"]})
    emit_comparison(39, rows, ("nel_h", "nel_v", "s", "ntracer"))
    emit({"phase": 39, "runs": runs, "timing": timing, "cpu": cpu, "checks_s": checks_s})
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"phase 39: the advection tangent kernels disagree with their plain versions: {bad[:4]}")
    if not all(c["err"] <= c["tol"] and c["iterations_card"] == c["iterations_cpu"] for c in cpu):
        raise AssertionError(f"phase 39: the card and the CPU differ: {cpu}")
    main_rows = [r for r in rows if (r["nel_h"], r["nel_v"], r["s"]) == ADVECTION_MAIN and r["dtype"] == "float64"]
    return {"launches": {"prep": main["launches"]["euler3d_advection_tangent_prep"],
                         "apply": main["launches"]["euler3d_advection_tangent_apply"]},
            "max_abs_err": {"prep": max(r["prep_max_abs_err"] for r in main_rows),
                            "apply": max(r["max_abs_err"] for r in main_rows)},
            "timing": timing[0]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "wxfactory_tpu_torch" / "csrc" / "sw_operator.cu").is_file():
        print("chip_smoke: run from the root of a checkout (wxfactory_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    smi = nvidia_smi()
    seconds = {}

    def timed(number, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[number] = round(time.perf_counter() - t0, 1)
        return out

    timed(0, phase0, torch, smi)
    sw_err = timed(1, phase1, torch)
    timed(2, phase2, torch)
    sw_launches = timed(3, phase3, torch)
    timed(4, phase4, torch, smi)
    e3_err = timed(5, phase5, torch)
    timed(6, phase6, torch)
    e3_launches = timed(7, phase7, torch)
    e3_timing = timed(8, phase8, torch, smi)
    tangent_err = timed(9, phase9, torch)
    timed(10, phase10, torch)
    tangent_launches = timed(11, phase11, torch)
    tangent_timing = timed(12, phase12, torch, smi)
    tangent_err.update(timed(13, phase13, torch))
    timed(14, phase14, torch)
    tangent_launches.update(timed(15, phase15, torch))
    pert_timing = timed(16, phase16, torch, smi)
    sw_errs = timed(17, phase17, torch)
    timed(18, phase18, torch)
    sw_counts = timed(19, phase19, torch)
    swt = timed(20, phase20, torch, smi)
    stage_err = timed(21, phase21, torch)
    stage_launches = timed(22, phase22, torch)
    timed(23, phase23, torch)
    stage_timing = timed(24, phase24, torch, smi)
    tile_err = timed(25, phase25, torch)
    tile_launches = timed(26, phase26, torch)
    timed(27, phase27, torch)
    tile_timing = timed(28, phase28, torch, smi)
    tangent_sw = timed(29, phase29, torch, smi)
    tangent_sw_launches = timed(30, phase30, torch)
    topo = timed(31, phase31, torch, smi)
    topo_launches = timed(32, phase32, torch)
    s1_launches = timed(33, phase33, torch)
    terrain = timed(34, phase34, torch, smi)
    pert_topo = timed(35, phase35, torch, smi)
    timed(36, phase36, torch)
    advection = timed(37, phase37, torch, smi)
    cartesian = timed(38, phase38, torch, smi)
    advection_tangent = timed(39, phase39, torch, smi)
    sw_entry = lambda name, mode, replaces, source="wxfactory_tpu_torch/csrc/sw_operator.cu", row=swt["sw_pert"]: {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": sw_counts[name],
        "max_abs_err": sw_errs[name], "ms": row[f"{mode}_kernel_ms"], "plain_ms": row[f"{mode}_plain_ms"],
        "bound_ms": row[f"{mode}_bound_ms"], "bound_by": row[f"{mode}_bound_by"], "library_ms": None}
    # The operator rows time the state mode, which every launch of the main
    # paths runs (rows 4 and 5 folded into its panel-edge faces); the
    # halo-plane mode's time and bound stand beside them for reference.
    folded = "state mode: pallas_sw.py:258 ke_edges and :374 kh_exchange folded into its panel-edge faces"
    state_entry = lambda name, launches, err, mode, plane, replaces: {
        "name": name, "route": "cuda", "source": "wxfactory_tpu_torch/csrc/sw_operator.cu", "replaces": replaces,
        "launches": launches, "max_abs_err": max(err, swt[name][f"{mode}_max_abs_err"]),
        "ms": swt[name][f"{mode}_kernel_ms"], "plain_ms": swt[name][f"{mode}_plain_ms"],
        "bound_ms": swt[name][f"{mode}_bound_ms"], "bound_by": swt[name][f"{mode}_bound_by"], "library_ms": None,
        "plane_mode": plane, "plane_ms": swt[name][f"{plane}_kernel_ms"],
        "plane_bound_ms": swt[name][f"{plane}_bound_ms"]}
    kernels = [
        state_entry("sw_operator", sw_launches, sw_err, "state_rhs", "rhs",
                    f"wxfactory_tpu/ops/pallas_sw_gen.py:632 ({folded})"),
        {"name": "euler3d_operator", "route": "cuda", "source": "wxfactory_tpu_torch/csrc/euler3d_operator.cu",
         "replaces": "wxfactory_tpu/ops/pallas_euler3d.py:2131", "launches": e3_launches,
         "max_abs_err": e3_err, "ms": e3_timing["kernel_rhs_ms"], "plain_ms": e3_timing["plain_rhs_ms"],
         "bound_ms": e3_timing["rhs_bound_ms"], "bound_by": e3_timing["rhs_bound_by"], "library_ms": None},
        *[{"name": f"euler3d_{form}tangent_{kernel}", "route": "cuda",
           "source": "wxfactory_tpu_torch/csrc/euler3d_operator.cu",
           "replaces": "wxfactory_tpu/ops/pallas_euler3d.py:2131 (tangent mode"
                       + (", perturbation form" if form else "") + (", its linearisation)" if kernel == "prep" else ")"),
           "launches": tangent_launches[f"euler3d_{form}tangent_{kernel}"],
           "max_abs_err": tangent_err[f"euler3d_{form}tangent_{kernel}"], "ms": timing[f"{kernel}_ms"],
           "plain_ms": timing[f"{kernel}_plain_ms"], "library_ms": None,
           # The apply is held to the function's bound (J.v from q and v);
           # its own floor, which counts the coefficients it reads, beside it.
           **({"bound_ms": timing["prep_bound_ms"], "bound_by": timing["prep_bound_by"]} if kernel == "prep" else
              {"bound_ms": timing["function_bound_ms"], "bound_by": timing["function_bound_by"],
               "apply_floor_ms": timing["apply_bound_ms"]})}
          for form, timing in (("", tangent_timing), ("pert_", pert_timing)) for kernel in ("prep", "apply")],
        state_entry("sw_pert", sw_counts["sw_pert"], sw_errs["sw_pert"], "state_pert_stage_x", "pert_stage_traces",
                    f"wxfactory_tpu/ops/pallas_sw_gen.py:632 (perturbation mode, {folded})"),
        sw_entry("sw_halo", "halo", "wxfactory_tpu/ops/pallas_sw.py:374"),
        sw_entry("sw_edges", "edges", "wxfactory_tpu/ops/pallas_sw.py:258"),
        sw_entry("sw_run", f"run_{RUN_STEPS}_steps", "wxfactory_tpu/ops/pallas_sw.py:1100",
                 "wxfactory_tpu_torch/csrc/sw_run.cu"),
        {"name": "euler3d_pert_stage", "route": "cuda", "source": "wxfactory_tpu_torch/csrc/euler3d_operator.cu",
         "replaces": "wxfactory_tpu/ops/pallas_euler3d.py:2131 (perturbation mode, stage + delta slabs)",
         "launches": stage_launches, "max_abs_err": stage_err, "ms": stage_timing["kernel_ms"],
         "plain_ms": stage_timing["plain_ms"], "bound_ms": stage_timing["bound_ms"],
         "bound_by": stage_timing["bound_by"], "library_ms": None},
    ]
    for name, source, replaces in (
            ("sw_tile", "wxfactory_tpu_torch/csrc/sw_operator.cu", "wxfactory_tpu/ops/pallas_sw_gen.py:822"),
            ("euler3d_tile", "wxfactory_tpu_torch/csrc/euler3d_operator.cu",
             "wxfactory_tpu/ops/pallas_euler3d.py:2543")):
        t = tile_timing[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": tile_launches[name], "max_abs_err": tile_err[name], "ms": t["kernel_ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": None})
    t = tangent_sw["timing"]
    for kernel in ("prep", "apply"):
        # The apply is held to the function's bound (J.v from q and v), the
        # prep to its own; the apply's own floor, which counts the
        # coefficients it reads, beside it.
        bound = ({"bound_ms": t["prep_own_bound_ms"], "bound_by": t["prep_own_bound_by"]} if kernel == "prep" else
                 {"bound_ms": t["function_bound_ms"], "bound_by": t["function_bound_by"],
                  "apply_floor_ms": t["apply_own_bound_ms"]})
        kernels.append({"name": f"sw_tangent_{kernel}", "route": "cuda",
                        "source": "wxfactory_tpu_torch/csrc/sw_operator.cu",
                        "replaces": "jax.jvp of wxfactory_tpu/models/shallow_water.py:166 (no Pallas kernel"
                                    + ("; its linearisation)" if kernel == "prep" else ")"),
                        "launches": tangent_sw_launches[f"sw_tangent_{kernel}"],
                        "max_abs_err": tangent_sw[f"{kernel}_max_abs_err"], "ms": t[f"{kernel}_kernel_ms"],
                        "plain_ms": t[f"{kernel}_plain_ms"], **bound, "library_ms": None})
    # The kernels with topography (timed at (64,3) float64 on case 5) and the
    # tangent pair at s = 1 (timed at (20,1), the first FV level of nel = 10).
    trow = lambda nel, s: next(t for t in topo["timing"] if (t["nel"], t["s"], t["dtype"]) == (nel, s, "float64"))
    t64, t1 = trow(64, 3), trow(20, 1)
    kernels.append({"name": "sw_operator_topo", "route": "cuda", "source": "wxfactory_tpu_torch/csrc/sw_operator.cu",
                    "replaces": "wxfactory_tpu/ops/pallas_sw_gen.py:632 (state mode with the bottom topography of "
                                "wxfactory_tpu/models/shallow_water.py:166-249)",
                    "launches": topo_launches["sw_operator_topo"], "max_abs_err": topo["sw_operator_topo"],
                    "ms": t64["rhs_topo_kernel_ms"], "plain_ms": t64["rhs_topo_plain_ms"],
                    "bound_ms": t64["rhs_topo_bound_ms"], "bound_by": t64["rhs_topo_bound_by"], "library_ms": None,
                    "ms_without_topography": t64["rhs_ms"]})
    for form, row, counts, tag in (("topo", t64, topo_launches, "_topo"), ("s1", t1, s1_launches, "")):
        for kernel in ("prep", "apply"):
            bound = ({"bound_ms": row[f"{kernel}{tag}_own_bound_ms"], "bound_by": row[f"{kernel}{tag}_own_bound_by"]}
                     if kernel == "prep" else
                     {"bound_ms": row[f"function{tag}_bound_ms"], "bound_by": row[f"function{tag}_bound_by"],
                      "apply_floor_ms": row[f"{kernel}{tag}_own_bound_ms"]})
            what = "with bottom topography" if form == "topo" else "at s = 1, the fv-mg FV levels"
            kernels.append({"name": f"sw_tangent_{kernel}_{form}", "route": "cuda",
                            "source": "wxfactory_tpu_torch/csrc/sw_operator.cu",
                            "replaces": f"jax.jvp of wxfactory_tpu/models/shallow_water.py:166 ({what}; no Pallas "
                                        "kernel" + ("; its linearisation)" if kernel == "prep" else ")"),
                            "launches": counts[f"sw_tangent_{kernel}_{form}"],
                            "max_abs_err": topo[f"sw_tangent_{kernel}_{form}"],
                            "ms": row[f"{kernel}{tag}_kernel_ms"], "plain_ms": row[f"{kernel}{tag}_plain_ms"], **bound,
                            "library_ms": None})
    # The terrain instantiations (DCMIP 20, 21, 22): the float64 rows timed on
    # DCMIP 21 with its sponge, the float32 ones on DCMIP 20's perturbation
    # form, at TERRAIN_MAIN; beside each the same call of the kernels without
    # terrain (DCMIP 31) in turns.
    f64_row, f32_row = terrain["timing"]
    for name, row, mode, what in (
            ("euler3d_operator_terrain", f64_row, "rhs", "RHS/stage on every panel's metric, with the Rayleigh sponge"),
            ("euler3d_pert_stage_terrain", f32_row, "stage_traces", "perturbation stage + delta slabs on every "
                                                                   "panel's metric"),
            ("euler3d_tangent_prep_terrain", f64_row, "prep", "tangent mode on every panel's metric, its "
                                                             "linearisation"),
            ("euler3d_tangent_apply_terrain", f64_row, "apply", "tangent mode on every panel's metric, with the "
                                                               "sponge's tangent"),
            ("euler3d_pert_tangent_prep_terrain", f32_row, "prep", "tangent mode, perturbation form, on every "
                                                                  "panel's metric, its linearisation"),
            ("euler3d_pert_tangent_apply_terrain", f32_row, "apply", "tangent mode, perturbation form, on every "
                                                                    "panel's metric")):
        kernels.append({"name": name, "route": "cuda", "source": "wxfactory_tpu_torch/csrc/euler3d_operator.cu",
                        "replaces": f"wxfactory_tpu/ops/pallas_euler3d.py:2131 ({what})",
                        "launches": terrain["launches"][name], **terrain["errors"][name],
                        "ms": row[f"{mode}_ms"], "plain_ms": row[f"{mode}_plain_ms"],
                        "bound_ms": row[f"{mode}_bound_ms"], "bound_by": row[f"{mode}_bound_by"],
                        "library_ms": None, "ms_without_terrain": row[f"{mode}_flat_ms"],
                        **({"apply_floor_ms": row["apply_floor_ms"]} if mode == "apply" else {})})
    # The perturbation form's state mode with topography (Williamson 5 and
    # 10's float32 companion and production point), timed at
    # PERT_TOPO_TIMED in float32 (stage + x: the chain's call; its RHS beside
    # it) in turns with the perturbation kernel without topography.
    ptrow = next(t for t in pert_topo["timing"]["timing"] if t["dtype"] == "float32")
    kernels.append({"name": "sw_pert_topo", "route": "cuda", "source": "wxfactory_tpu_torch/csrc/sw_operator.cu",
                    "replaces": "wxfactory_tpu/ops/pallas_sw_gen.py:632 (perturbation mode with the bottom "
                                "topography of wxfactory_tpu/models/shallow_water.py:254-443, which the JAX "
                                "package runs in XLA)",
                    "launches": pert_topo["launches"], "max_abs_err": pert_topo["max_abs_err"],
                    "ms": ptrow["stage_x_kernel_ms"], "plain_ms": ptrow["stage_x_plain_ms"],
                    "bound_ms": ptrow["stage_x_bound_ms"], "bound_by": ptrow["stage_x_bound_by"], "library_ms": None,
                    "ms_without_topography": ptrow["stage_x_flat_ms"], "rhs_ms": ptrow["rhs_kernel_ms"],
                    "rhs_bound_ms": ptrow["rhs_bound_ms"]})
    # The tracer advection of DCMIP 11/12, timed at the main path's width in
    # float64 on the stage + x + traces call the TVD-RK3 chain makes (its RHS
    # beside it).
    at = advection["timing"]
    kernels.append({"name": "euler3d_advection", "route": "cuda",
                    "source": "wxfactory_tpu_torch/csrc/euler3d_advection.cu",
                    "replaces": "XLA `_euler3d_rhs_core(advection_only=True)`, "
                                "wxfactory_tpu/models/euler_cubesphere.py:90-291 (no Pallas kernel)",
                    "launches": advection["launches"], "max_abs_err": advection["max_abs_err"],
                    "ms": at["stage_x_traces_kernel_ms"], "plain_ms": at["stage_x_traces_plain_ms"],
                    "bound_ms": at["stage_x_traces_bound_ms"], "bound_by": at["stage_x_traces_bound_by"],
                    "library_ms": None, "rhs_ms": at["rhs_kernel_ms"], "rhs_bound_ms": at["rhs_bound_ms"]})
    # The 2D Cartesian kernels, timed at the main paths' widths in float64:
    # the DFR stage with x (the TVD-RK3 chain's call; its RHS beside it) and
    # its tangent at 256 x 64, s = 4; the FV tangent at the fv-mg level of
    # path (c), 40 x 60 cells. The FV RHS kernel, which no path launches, is
    # in phase 38's line, not here.
    ct = cartesian["timing"]
    for name, mode, replaces in (
            ("euler_cartesian", "stage_x", "XLA `make_rhs_euler_cartesian`, wxfactory_tpu/models/euler_cartesian.py:"
                                           "115-186 (no Pallas kernel)"),
            ("euler_cartesian_tangent", "tangent", "jax.jvp of wxfactory_tpu/models/euler_cartesian.py:115-186 (no "
                                                   "Pallas kernel)"),
            ("euler_cartesian_fv_tangent", "fv_tangent", "jax.jvp of wxfactory_tpu/models/euler_cartesian_fv.py:"
                                                         "64-92 (no Pallas kernel)")):
        kernels.append({"name": name, "route": "cuda", "source": "wxfactory_tpu_torch/csrc/euler_cartesian.cu",
                        "replaces": replaces, "launches": cartesian["launches"][name],
                        "max_abs_err": cartesian["max_abs_err"][name], "ms": ct[f"{mode}_kernel_ms"],
                        "plain_ms": ct[f"{mode}_plain_ms"], "bound_ms": ct[f"{mode}_bound_ms"],
                        "bound_by": ct[f"{mode}_bound_by"], "library_ms": None,
                        **({"rhs_ms": ct["rhs_kernel_ms"], "rhs_bound_ms": ct["rhs_bound_ms"]}
                           if name == "euler_cartesian" else {})})
    # The Jacobian action of the DCMIP 11/12 advection, timed at the main
    # path's width in float64 with 4 tracers; launches from path (b).
    tt = advection_tangent["timing"]
    for kernel in ("prep", "apply"):
        # The apply is held to the function's bound (J.v from q and v), the
        # prep to its own; the apply's own floor beside it.
        bound = ({"bound_ms": tt["prep_own_bound_ms"], "bound_by": tt["prep_own_bound_by"]} if kernel == "prep" else
                 {"bound_ms": tt["function_bound_ms"], "bound_by": tt["function_bound_by"],
                  "apply_floor_ms": tt["apply_own_bound_ms"]})
        kernels.append({"name": f"euler3d_advection_tangent_{kernel}", "route": "cuda",
                        "source": "wxfactory_tpu_torch/csrc/euler3d_advection_tangent.cu",
                        "replaces": "jax.jvp of XLA `_euler3d_rhs_core(advection_only=True)`, "
                                    "wxfactory_tpu/models/euler_cubesphere.py:90-291 (no Pallas kernel"
                                    + ("; its linearisation)" if kernel == "prep" else ")"),
                        "launches": advection_tangent["launches"][kernel],
                        "max_abs_err": advection_tangent["max_abs_err"][kernel], "ms": tt[f"{kernel}_kernel_ms"],
                        "plain_ms": tt[f"{kernel}_plain_ms"], **bound, "library_ms": None})
    unmeasured = [k["name"] for k in kernels if not (k["ms"] > 0 and k["plain_ms"] > 0 and k["launches"] > 0)]
    if unmeasured:
        raise AssertionError(f"kernels without a time, a plain time or a launch on the main path: {unmeasured}")
    emit({"phase_seconds": seconds})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
