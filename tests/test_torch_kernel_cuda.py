"""The port's CUDA kernels (SW operator and its perturbation mode and their
shared-memory use, the SW halo, edge-trace, whole-run and tangent (J.v) kernels, the SW state mode and tangent
pair with bottom topography, the SW perturbation form with bottom topography, the SW tangent pair at s = 1 and the multigrid levels that launch it, 3D Euler
operator, its tangent
prep and apply kernels and the perturbation form of both, with its stage mode, their terrain instantiations
(DCMIP 20, 21, 22: every panel's metric, the Rayleigh sponge), the tracer-advection kernel of DCMIP 11 and 12 and its tangent prep and apply kernels, the
2D Cartesian Euler kernels (the DFR operator and its tangent, the FV operator and its tangent), and
the tile kernels of both models with the tile steps' launch counts) against their plain torch versions, on the card. Needs a CUDA device and nvcc, and skips without them. On a GPU
machine run it without tests/conftest.py (which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Tolerances and scales: wxfactory_tpu_torch/kernels/check.py. The check of
record at the main path's shapes is chip_smoke.py."""

import pytest
import torch

from wxfactory_tpu_torch.kernels.check import (
    E3_TILE_SHAPES,
    SW_TILE_SHAPES,
    advection_direction,
    advection_inputs,
    case6_inputs,
    compare_euler3d_advection,
    compare_euler3d_advection_tangent,
    compare_euler_cartesian,
    compare_euler_cartesian_fv,
    euler_cartesian_inputs,
    compare_euler3d_tile,
    compare_sw_tile,
    euler3d_setup,
    sw_setup,
    compare_euler3d_operator,
    compare_euler3d_pert,
    compare_euler3d_pert_stage,
    compare_euler3d_tangent,
    compare_sponge_rows,
    compare_terrain_flat,
    compare_sw_edges,
    compare_sw_halo,
    compare_sw_operator,
    compare_sw_pert,
    compare_sw_pert_topo,
    compare_sw_run,
    compare_sw_state_halo,
    compare_sw_tangent,
    compare_sw_topo_operator,
    euler3d_inputs,
    euler3d_pert_inputs,
    euler3d_tangent_inputs,
    pert_halos,
    sw_kernel_resources,
    sw_tangent_inputs,
    sw_tangent_resources,
    sw_pert_inputs,
    sw_pert_topo_inputs,
    tangent_halos,
)
from wxfactory_tpu_torch.ops import euler3d_operator as e3op
from wxfactory_tpu_torch.ops import euler_cartesian_operator as ecop
from wxfactory_tpu_torch.ops import sw_operator as swop

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel,s", [(4, 2), (5, 3), (3, 8)])
def test_kernel_matches_plain(cuda, nel, s, dtype):
    rows = compare_sw_operator(nel, s, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows


def test_launch_counter_counts_kernel_launches_only(cuda):
    con, topology, x, y = case6_inputs(3, 3, torch.float64, "cuda")
    halo = swop.halo_from_traces(swop.edge_traces(y, con), topology)
    before = swop.launches
    swop.sw_operator_plain(y, halo, con)
    assert swop.launches == before
    swop.sw_operator(y, halo, con, x=x, a=0.5, b=0.5, cdt=1.0, emit_traces=True)
    torch.cuda.synchronize()
    assert swop.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel_h,nel_v,s,case", [(3, 2, 2, 31), (4, 2, 3, 77), (2, 2, 6, 31)])
def test_euler3d_kernel_matches_plain(cuda, nel_h, nel_v, s, case, dtype):
    rows = compare_euler3d_operator(nel_h, nel_v, s, dtype, device="cuda", case=case)
    assert all(r["ok"] for r in rows), rows


def test_euler3d_launch_counter_counts_kernel_launches_only(cuda):
    con, topology, x, y = euler3d_inputs(3, 2, 3, torch.float64, "cuda")
    halo = e3op.halo_from_traces(e3op.edge_traces(y, con), topology)
    before = e3op.launches
    e3op.euler3d_operator_plain(y, halo, con)
    assert e3op.launches == before
    e3op.euler3d_operator(y, halo, con, x=x, a=0.5, b=0.5, cdt=1.0, emit_traces=True)
    torch.cuda.synchronize()
    assert e3op.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel_h,nel_v,s,case", [(3, 2, 2, 31), (4, 2, 3, 77), (2, 2, 6, 31)])
def test_euler3d_tangent_kernel_matches_plain(cuda, nel_h, nel_v, s, case, dtype):
    row = compare_euler3d_tangent(nel_h, nel_v, s, dtype, device="cuda", case=case)
    assert row["ok"], row


def test_euler3d_tangent_counters_count_kernel_launches_and_plain_calls(cuda):
    con, topology, q, v = euler3d_tangent_inputs(3, 2, 3, torch.float64, "cuda")
    halo_q, halo_v = tangent_halos(q, v, con, topology)
    launches, plain = e3op.tangent_launches, e3op.plain_tangent_calls
    e3op.euler3d_tangent_plain(q, v, halo_q, halo_v, con)
    assert (e3op.tangent_launches, e3op.plain_tangent_calls) == (launches, plain + 1)
    e3op.euler3d_tangent(q, v, halo_q, halo_v, con)
    torch.cuda.synchronize()
    assert (e3op.tangent_launches, e3op.plain_tangent_calls) == (launches + 1, plain + 1)


@pytest.mark.parametrize("pert_form", [False, True], ids=["absolute", "perturbation"])
def test_jtv_launches_one_prep_and_one_apply_per_action(cuda, pert_form):
    """Euler3DRHS on the card: jtv_prep launches the prep once, each
    jtv_apply the apply once and nothing plain; J.v equals the plain
    tangent within 1e-12 of scale and the apply is linear in v."""
    from wxfactory_tpu_torch.models import Euler3DRHS

    geom, ops, metric, topology, q0 = euler3d_setup(3, 2, 3, 31)
    rhs = Euler3DRHS(geom, ops, metric, device="cuda", topology=topology,
                     perturbation_base=q0 if pert_form else None)
    con, _, q, v = euler3d_tangent_inputs(3, 2, 3, torch.float64, "cuda")
    counts = lambda: (e3op.tangent_prep_launches, e3op.tangent_launches, e3op.pert_tangent_launches,
                      e3op.plain_calls, e3op.plain_tangent_calls)
    before = counts()
    prep = rhs.jtv_prep(q)
    got = [rhs.jtv_apply(prep, x) for x in (v, 2.0 * v, v.flip(-1).contiguous())]
    torch.cuda.synchronize()
    applies = (0, 3) if pert_form else (3, 0)
    assert counts() == (before[0] + 1, before[1] + applies[0], before[2] + applies[1], before[3], before[4])
    q_in, qa, traces, halo_q, coef = prep
    halo_v = rhs.halo(e3op.edge_traces_tangent(qa, v, con, traces))
    want = (e3op.euler3d_tangent_pert_plain(q_in, v, halo_q, halo_v, con, rhs.pert) if pert_form
            else e3op.euler3d_tangent_plain(q_in, v, halo_q, halo_v, con))
    scale = want.abs().reshape(5, -1).amax(dim=1).reshape(5, 1, 1, 1, 1, 1)
    assert float(((got[0] - want).abs() / scale).max()) < 1e-12
    assert float(((got[1] - 2.0 * got[0]).abs() / scale).max()) < 1e-13


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel_h,nel_v,s,case", [(3, 2, 2, 31), (4, 2, 3, 77), (2, 2, 6, 31)])
def test_euler3d_pert_kernel_matches_plain(cuda, nel_h, nel_v, s, case, dtype):
    rows = compare_euler3d_pert(nel_h, nel_v, s, dtype, device="cuda", case=case)
    assert all(r["ok"] for r in rows), rows


def test_euler3d_pert_counters_count_kernel_launches_only(cuda):
    con, topology, pert, dq, v = euler3d_pert_inputs(3, 2, 3, torch.float64, "cuda")
    halo_dq, halo_v = pert_halos(dq, v, pert, con, topology)
    counts = lambda: (e3op.launches, e3op.tangent_launches, e3op.pert_launches, e3op.pert_tangent_launches,
                      e3op.plain_tangent_calls)
    before = counts()
    e3op.euler3d_operator_pert_plain(dq, halo_dq, con, pert)
    e3op.euler3d_tangent_pert_plain(dq, v, halo_dq, halo_v, con, pert)
    assert counts() == before[:4] + (before[4] + 1,)
    e3op.euler3d_operator(dq, halo_dq, con, pert=pert)
    e3op.euler3d_tangent(dq, v, halo_dq, halo_v, con, pert=pert)
    torch.cuda.synchronize()
    assert counts() == before[:2] + (before[2] + 1, before[3] + 1, before[4] + 1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel_h,nel_v,s,case", [(3, 2, 2, 31), (4, 2, 3, 77), (2, 2, 4, 31), (2, 2, 6, 31)])
def test_euler3d_pert_stage_kernel_matches_plain(cuda, nel_h, nel_v, s, case, dtype):
    rows = compare_euler3d_pert_stage(nel_h, nel_v, s, dtype, device="cuda", case=case)
    assert all(r["ok"] for r in rows), rows


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_euler3d_operator_conserves_mass_at_a_ragged_shape(cuda, dtype):
    # nel_h = 7 (and tiles of nt = 7): 147 elements a panel leave the volume
    # pass (9 elements a block at s=3) a partial last block; every call's rho
    # change integrates to the plain version's within round-off
    # (kernels/check.py, mass_err).
    rows = compare_euler3d_operator(7, 3, 3, dtype, device="cuda")
    rows += [r for r in compare_euler3d_pert(7, 3, 3, dtype, device="cuda") if r["mode"] == "pert_rhs"]
    rows += compare_euler3d_pert_stage(7, 3, 3, dtype, device="cuda")
    rows += compare_euler3d_tile(7, 3, 3, 31, 2, dtype, device="cuda")
    assert all(r["mass_err"] <= r["mass_tol"] for r in rows), [(r["mode"], r["mass_err"], r["mass_tol"]) for r in rows]
    assert all(r["ok"] for r in rows), rows


def test_euler3d_pert_stage_counter_counts_stage_launches_only(cuda):
    con, topology, pert, dq, _ = euler3d_pert_inputs(3, 2, 3, torch.float32, "cuda")
    halo = e3op.halo_from_traces(e3op.edge_traces_delta(dq, pert, con), topology)
    counts = lambda: (e3op.launches, e3op.pert_launches, e3op.pert_stage_launches)
    before = counts()
    e3op.euler3d_operator_pert_plain(dq, halo, con, pert, cdt=0.1, emit_traces=True)
    assert counts() == before
    e3op.euler3d_operator(dq, halo, con, x=dq, a=0.5, b=0.5, cdt=0.1, emit_traces=True, pert=pert)
    e3op.euler3d_operator(dq, halo, con, pert=pert)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1] + 1, before[2] + 1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel,s", [(4, 2), (5, 3), (8, 4), (3, 8)])
def test_sw_pert_kernel_matches_plain(cuda, nel, s, dtype):
    rows = compare_sw_pert(nel, s, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel,s", [(4, 2), (5, 3), (32, 4), (3, 8)])
def test_sw_halo_and_edge_kernels_match_plain(cuda, nel, s, dtype):
    rows = compare_sw_halo(nel, s, dtype, device="cuda") + compare_sw_edges(nel, s, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel,s", [(4, 2), (5, 3), (8, 4), (3, 5), (2, 6), (3, 7), (3, 8)])
def test_sw_state_halo_matches_halo_kernels(cuda, nel, s, dtype):
    # The operator's state mode (halo=None) bit for bit the operator fed
    # sw_halo(sw_edges(q)), absolute and perturbation, RHS and stages.
    rows = compare_sw_state_halo(nel, s, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel,s", [(4, 2), (5, 3), (10, 3), (3, 5), (2, 6), (3, 8)])
def test_sw_tangent_kernel_matches_plain(cuda, nel, s, dtype):
    # J(q).v of the tangent prep and apply kernels at case 6 and at rest (the
    # split Mach number's tie) against torch.func.jvp of the plain operator,
    # each kernel against its plain version: linearity, mass, and (f64) the
    # centred difference's second order; one prep launch a linearisation
    # point, one apply launch a J.v, no plain call.
    rows = compare_sw_tangent(nel, s, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows
    con, topology, states, v, _ = sw_tangent_inputs(nel, s, dtype, "cuda")
    counts = lambda: (swop.tangent_prep_launches, swop.tangent_apply_launches, swop.plain_calls,
                      swop.plain_tangent_calls)
    before = counts()
    coef = swop.sw_tangent_prep(states["case6"], con, topology)
    swop.sw_tangent_apply(coef, v, con, topology)
    swop.sw_tangent(states["case6"], v, con, topology)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 2, before[1] + 2, before[2], before[3])
    info = sw_tangent_resources(dtype, s)
    assert info["apply"]["smem_bytes"] < 48 * 1024 and info["apply"]["blocks_per_sm"] >= 1, info
    assert info["prep"]["blocks_per_sm"] >= 1, info


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("pert", [False, True], ids=["absolute", "perturbation"])
def test_sw_run_kernel_matches_plain_and_chain(cuda, pert, dtype):
    row = compare_sw_run(32, dtype, 2, pert, device="cuda")
    assert row["ok"], row


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_sw_kernels_hold_only_the_1d_factors_in_shared_memory(cuda, dtype):
    # The sum-factorised element body keeps 8s + 2s^2 factor words and each
    # element's own regions in shared memory, so every instantiation fits
    # under 32 KB a block (the dense EE/DD/CC blocks took 119.8 KB at s=8
    # float64) and at least two blocks stay resident an SM.
    for s in range(2, 9):
        for form, info in sw_kernel_resources(dtype, s).items():
            assert info["smem_bytes"] < 32 * 1024, (s, form, info)
            assert info["blocks_per_sm"] >= 2, (s, form, info)


def test_sw_counters_count_kernel_launches_only(cuda):
    con, topology, base, dq, x = sw_pert_inputs(8, 4, torch.float64, "cuda")
    counts = lambda: (swop.launches, swop.pert_launches, swop.edge_launches, swop.halo_launches,
                      swop.run_launches, swop.state_launches)
    before, plain = counts(), swop.plain_calls
    swop.sw_run_plain(dq, 1, swop.tvdrk3_abc(30.0), con, topology, base=base)
    assert counts() == before and swop.plain_calls > plain
    plain = swop.plain_calls
    swop.sw_chain(dq, 1, swop.tvdrk3_abc(30.0), con, topology, base=base)
    swop.sw_run(dq, 1, swop.tvdrk3_abc(30.0), con, topology, base=base)
    torch.cuda.synchronize()
    # the chain: one state-mode operator launch a stage, no edge or halo launch
    assert counts() == (before[0], before[1] + 3, before[2], before[3], before[4] + 1, before[5] + 3)
    assert swop.plain_calls == plain


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nt,s,n", SW_TILE_SHAPES)
def test_sw_tile_kernel_matches_plain(cuda, nt, s, n, dtype):
    rows = compare_sw_tile(nt, s, n, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nt,nk,s,case,n", E3_TILE_SHAPES)
def test_euler3d_tile_kernel_matches_plain(cuda, nt, nk, s, case, n, dtype):
    rows = compare_euler3d_tile(nt, nk, s, case, n, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows


@pytest.mark.parametrize("n", [1, 2])
def test_tile_steps_count_one_launch_a_tile_and_stage(cuda, n):
    from wxfactory_tpu_torch.parallel import TileMesh
    from wxfactory_tpu_torch.parallel.shard_map_euler3d_fused import make_shard_map_euler3d_step_fused
    from wxfactory_tpu_torch.parallel.shard_map_sw_fused import make_shard_map_sw_step_fused

    geom, ops, metric, topology, q0 = sw_setup(8, 3)
    step = make_shard_map_sw_step_fused(geom, ops, metric, TileMesh(n), 30.0, dtype=torch.float64, device="cuda",
                                        topology=topology)
    before, plain = (swop.launches, swop.tile_launches, swop.pert_tile_launches), swop.plain_calls
    step(step(torch.as_tensor(q0, device="cuda")))
    torch.cuda.synchronize()
    assert (swop.launches, swop.tile_launches, swop.pert_tile_launches) == (
        before[0], before[1] + 2 * 3 * 6 * n * n, before[2])
    assert swop.plain_calls == plain

    geom, ops, metric, topology, q0 = euler3d_setup(4, 3, 2, 31)
    step = make_shard_map_euler3d_step_fused(geom, ops, metric, TileMesh(n), 1.0, dtype=torch.float32,
                                             perturbation_base=q0, device="cuda", topology=topology)
    before, plain = (e3op.launches, e3op.tile_launches, e3op.pert_tile_launches), e3op.plain_calls
    step(step(torch.as_tensor(q0, dtype=torch.float32, device="cuda")))
    torch.cuda.synchronize()
    assert (e3op.launches, e3op.tile_launches, e3op.pert_tile_launches) == (
        before[0], before[1], before[2] + 2 * 3 * 6 * n * n)
    assert e3op.plain_calls == plain


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel,s", [(4, 2), (5, 3), (3, 5), (3, 8)])
def test_sw_topography_kernels_match_plain(cuda, nel, s, dtype):
    # The state mode with case-5 topography (RHS, stages) against its plain
    # version with mass, its null planes bit for bit the kernel without
    # topography and its all-zero planes bit for bit the null ones; the
    # tangent pair with topography against the plain tangent (compare_sw_tangent
    # case 5), counted in topo_launches and topo_tangent_*_launches.
    counts = lambda: (swop.topo_launches, swop.topo_tangent_prep_launches, swop.topo_tangent_apply_launches)
    before = counts()
    rows = compare_sw_topo_operator(nel, s, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows
    rows = compare_sw_tangent(nel, s, dtype, device="cuda", case=5)
    assert all(r["ok"] for r in rows), rows
    assert all(after > b for after, b in zip(counts(), before))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel,s", [(4, 2), (5, 3), (3, 5), (3, 8)])
def test_sw_pert_topography_kernel_matches_plain(cuda, nel, s, dtype):
    # The perturbation form's state mode with case-5 topography (RHS, stage,
    # stage + x) against its plain version with mass; a launch counts in
    # pert_topo_launches, pert_launches and state_launches, and not in
    # topo_launches (the absolute kernel with topography, which builds the
    # base's float64 RHS).
    rows = compare_sw_pert_topo(nel, s, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows
    con, topology, base, topo, dq, _ = sw_pert_topo_inputs(nel, s, dtype, "cuda")
    counts = lambda: (swop.pert_topo_launches, swop.pert_launches, swop.state_launches, swop.topo_launches)
    before = counts()
    swop.sw_operator(dq, None, con, base=base, topology=topology, topo=topo)
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1, 0]


def test_sw_pert_topography_refuses_a_mismatched_base(cuda):
    con, topology, base, topo, dq, x = sw_pert_topo_inputs(4, 3, torch.float32, "cuda")
    with pytest.raises(ValueError, match="with topography"):
        swop.sw_operator(dq, None, con, base=base, topology=topology)
    halo = swop.sw_halo(swop.sw_edges(dq, con), topology)
    with pytest.raises(ValueError, match="halo"):
        swop.sw_operator(dq, halo, con, base=base, topology=topology, topo=topo)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel", [4, 8, 20])
def test_sw_tangent_kernels_at_s1_match_plain(cuda, nel, dtype):
    # The pure finite-volume levels of fv-mg: the tangent pair at s = 1.
    before = (swop.s1_tangent_prep_launches, swop.s1_tangent_apply_launches)
    rows = compare_sw_tangent(nel, 1, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows
    assert swop.s1_tangent_prep_launches > before[0] and swop.s1_tangent_apply_launches > before[1]


def test_fvmg_levels_run_on_the_tangent_kernels(cuda):
    # A V-cycle of fv-mg (three levels: DG(3), FV at nel 8 and 4) on the card
    # against the same V-cycle on the CPU; every level's A.v is one apply
    # launch, its prepare one prep launch, and nothing runs a plain version.
    from wxfactory_tpu_torch.geometry import make_cubed_sphere_2d
    from wxfactory_tpu_torch.precondition import Multigrid

    # case 6 with seeded noise: on its symmetry lines hu2 is zero to rounding,
    # where the split Mach number's kink lets two correct J.v differ
    _, _, states, _, _ = sw_tangent_inputs(4, 3, torch.float64, "cpu")
    kw = dict(kind="fv-mg", num_levels=3, pseudo_cfl=20.0, smoother="erk3")
    q = states["case6"]
    v = torch.randn(q.numel(), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    out = {}
    for device in ("cpu", "cuda"):
        mg = Multigrid.for_geometry(make_cubed_sphere_2d(4, 3), device=device, **kw)
        before = (swop.tangent_prep_launches, swop.tangent_apply_launches, swop.plain_calls, swop.plain_tangent_calls)
        mg.prepare(1800.0, q.to(device))
        out[device] = mg(v.to(device)).cpu()
        if device == "cuda":
            torch.cuda.synchronize()
            assert [lv.num_solpts for lv in mg.levels] == [3, 1, 1]
            applies = sum(lv.applies for lv in mg.levels)
            assert (swop.tangent_prep_launches - before[0], swop.tangent_apply_launches - before[1]) == (3, applies)
            assert (swop.plain_calls, swop.plain_tangent_calls) == before[2:]
    assert float((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()) < 1e-10


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel_h,nel_v,s", [(3, 2, 2), (4, 3, 3)])
def test_euler3d_terrain_kernels_match_plain(cuda, nel_h, nel_v, s, dtype):
    """The terrain instantiations: DCMIP 21 (with its sponge) and 20 in
    absolute form, the tangent pair on 21, 20's perturbation form."""
    rows = compare_euler3d_operator(nel_h, nel_v, s, dtype, device="cuda", case=21)
    rows += compare_euler3d_operator(nel_h, nel_v, s, dtype, device="cuda", case=20)
    rows.append(compare_euler3d_tangent(nel_h, nel_v, s, dtype, device="cuda", case=21))
    rows += compare_euler3d_pert(nel_h, nel_v, s, dtype, device="cuda", case=20)
    rows += compare_euler3d_pert_stage(nel_h, nel_v, s, dtype, device="cuda", case=20)
    rows.append(compare_sponge_rows(nel_h, nel_v, s, dtype, device="cuda"))
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel_h,nel_v,s", [(3, 2, 2), (2, 2, 6)])
def test_euler3d_terrain_kernels_on_flat_constants_equal_flat_kernels(cuda, nel_h, nel_v, s, dtype):
    row = compare_terrain_flat(nel_h, nel_v, s, dtype, device="cuda")
    assert row["ok"], row["identical"]


def test_euler3d_terrain_counters_count_terrain_launches_only(cuda):
    from wxfactory_tpu_torch.kernels.check import euler3d_constants

    con = euler3d_constants(3, 2, 2, 21, torch.float64, "cuda")
    _, topology, x, y = euler3d_inputs(3, 2, 2, torch.float64, "cuda", case=21)
    halo = e3op.halo_from_traces(e3op.edge_traces(y, con), topology)
    before = (e3op.launches, e3op.terrain_launches, e3op.terrain_tangent_prep_launches,
              e3op.terrain_tangent_apply_launches, e3op.tangent_launches, e3op.tangent_prep_launches)
    e3op.euler3d_operator(y, halo, con)
    coef = e3op.euler3d_tangent_prep(y, halo, con)
    e3op.euler3d_tangent_apply(x, halo, coef, con)
    after = (e3op.launches, e3op.terrain_launches, e3op.terrain_tangent_prep_launches,
             e3op.terrain_tangent_apply_launches, e3op.tangent_launches, e3op.tangent_prep_launches)
    assert [a - b for a, b in zip(after, before)] == [0, 1, 1, 1, 0, 0]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("ntracer", [1, 4])
@pytest.mark.parametrize("nel_h,nel_v,s", [(3, 2, 2), (4, 3, 3), (2, 2, 4), (2, 1, 5), (2, 2, 6)])
def test_euler3d_advection_kernel_matches_plain(cuda, nel_h, nel_v, s, ntracer, dtype):
    """RHS (rows 0-4 exactly 0), stage, stage + x and stage + x + traces,
    each tracer's mass against the plain version's and the RHS's own mass
    integral zero to round-off (kernels/check.py)."""
    rows = compare_euler3d_advection(nel_h, nel_v, s, ntracer, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows


def test_euler3d_advection_counter_counts_kernel_launches_only(cuda):
    con, topology, _, x, y = advection_inputs(3, 2, 2, 4, torch.float64, "cuda")
    halo = e3op.halo_from_traces(e3op.edge_traces(y, con), topology)
    before, plain = e3op.advection_launches, e3op.plain_calls
    e3op.euler3d_advection_plain(y, halo, con)
    assert e3op.advection_launches == before and e3op.plain_calls == plain + 1
    e3op.euler3d_advection(y, halo, con, x=x, a=0.5, b=0.5, cdt=1.0, emit_traces=True)
    torch.cuda.synchronize()
    assert e3op.advection_launches == before + 1 and e3op.plain_calls == plain + 1
    with pytest.raises(ValueError, match="1 or 4"):
        e3op.euler3d_advection(torch.cat([y, y[5:6]]).contiguous(), torch.cat([halo, halo[5:6]]).contiguous(), con)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("ntracer", [1, 4])
@pytest.mark.parametrize("nel_h,nel_v,s", [(3, 2, 2), (4, 3, 3), (2, 2, 4), (2, 1, 5), (2, 2, 6)])
def test_euler3d_advection_tangent_kernels_match_plain(cuda, nel_h, nel_v, s, ntracer, dtype):
    """The advection tangent's prep + apply against the plain pair (random
    direction with every row set; zero normal speed on both sides of some
    interfaces), each kernel against its plain version, J.(0, dT) against
    the RHS kernel, each tracer's mass (kernels/check.py)."""
    rows = compare_euler3d_advection_tangent(nel_h, nel_v, s, ntracer, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows


def test_euler3d_advection_tangent_counters_count_kernel_launches_only(cuda):
    con, topology, _, _, y = advection_inputs(3, 2, 2, 4, torch.float64, "cuda")
    v = advection_direction(y)
    halo_q, halo_v = tangent_halos(y, v, con, topology)
    counts = lambda: (e3op.advection_tangent_prep_launches, e3op.advection_tangent_apply_launches, e3op.plain_calls,
                      e3op.plain_tangent_calls)
    before = counts()
    e3op.euler3d_advection_tangent_plain(y, v, halo_q, halo_v, con)
    coef = e3op.euler3d_advection_tangent_prep(y, halo_q, con)
    e3op.euler3d_advection_tangent_apply(v, halo_v, coef, con)
    e3op.euler3d_advection_tangent_apply(v, halo_v, coef, con)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 2, 1, 1]
    with pytest.raises(ValueError, match="1 or 4"):
        e3op.euler3d_advection_tangent_prep(torch.cat([y, y[5:6]]).contiguous(),
                                            torch.cat([halo_q, halo_q[5:6]]).contiguous(), con)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nel_x,nel_z,s,case", [(4, 3, 2, 2), (3, 2, 3, 4), (4, 3, 4, 2), (2, 2, 5, 4), (2, 1, 6, 2)])
def test_euler_cartesian_kernels_match_plain(cuda, nel_x, nel_z, s, case, dtype):
    """The DFR kernel (RHS, stage, stage + x; the RHS's rho and rho*theta
    mass zero to round-off) and its tangent kernel (at a perturbed state and
    at rest, where every AUSM interface sits at its tie) against their plain
    versions (kernels/check.py)."""
    rows = compare_euler_cartesian(nel_x, nel_z, s, dtype, device="cuda", case=case)
    assert all(r["ok"] for r in rows), rows


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("flux", ["ausm", "rusanov", "upwind"])
def test_euler_cartesian_fv_kernels_match_plain(cuda, flux, dtype):
    """The FV kernel (RHS) and its tangent kernel (at a perturbed state and
    at rest: every speed at its tie) against their plain versions."""
    rows = compare_euler_cartesian_fv(9, 7, flux, dtype, device="cuda")
    assert all(r["ok"] for r in rows), rows


def test_euler_cartesian_counters_count_kernel_launches_only(cuda):
    ops, _, con, x, y, v, q0 = euler_cartesian_inputs(4, 3, 3, torch.float64, "cuda")
    counts = lambda: (ecop.launches, ecop.tangent_launches, ecop.plain_calls, ecop.plain_tangent_calls)
    before = counts()
    ecop.euler_cartesian_plain(y, con)
    ecop.euler_cartesian_tangent_plain(y, v, con)
    ecop.euler_cartesian(y, con, x=x, a=0.5, b=0.5, cdt=1.0)
    ecop.euler_cartesian_tangent(y, v, con)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1, 1]
    with pytest.raises(ValueError, match="s = 2..6"):
        _, _, con7, _, y7, _, _ = euler_cartesian_inputs(2, 2, 7, torch.float64, "cuda")
        ecop.euler_cartesian(y7, con7)
