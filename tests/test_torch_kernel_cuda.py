"""The port's CUDA kernels (SW operator and its perturbation mode, the SW
halo, edge-trace and whole-run kernels, 3D Euler operator, its tangent
mode and the perturbation form of both) against their plain torch versions, on the card. Needs a CUDA device and nvcc, and skips without them. On a GPU
machine run it without tests/conftest.py (which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Tolerances and scales: wxfactory_tpu_torch/kernels/check.py. The check of
record at the main path's shapes is chip_smoke.py."""

import pytest
import torch

from wxfactory_tpu_torch.kernels.check import (
    case6_inputs,
    compare_euler3d_operator,
    compare_euler3d_pert,
    compare_euler3d_tangent,
    compare_sw_edges,
    compare_sw_halo,
    compare_sw_operator,
    compare_sw_pert,
    compare_sw_run,
    euler3d_inputs,
    euler3d_pert_inputs,
    euler3d_tangent_inputs,
    pert_halos,
    sw_pert_inputs,
    tangent_halos,
)
from wxfactory_tpu_torch.ops import euler3d_operator as e3op
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
@pytest.mark.parametrize("pert", [False, True], ids=["absolute", "perturbation"])
def test_sw_run_kernel_matches_plain_and_chain(cuda, pert, dtype):
    row = compare_sw_run(32, dtype, 2, pert, device="cuda")
    assert row["ok"], row


def test_sw_counters_count_kernel_launches_only(cuda):
    con, topology, base, dq, x = sw_pert_inputs(8, 4, torch.float64, "cuda")
    counts = lambda: (swop.launches, swop.pert_launches, swop.edge_launches, swop.halo_launches,
                      swop.run_launches)
    before, plain = counts(), swop.plain_calls
    swop.sw_run_plain(dq, 1, swop.tvdrk3_abc(30.0), con, topology, base=base)
    assert counts() == before and swop.plain_calls > plain
    plain = swop.plain_calls
    swop.sw_chain(dq, 1, swop.tvdrk3_abc(30.0), con, topology, base=base)
    swop.sw_run(dq, 1, swop.tvdrk3_abc(30.0), con, topology, base=base)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1] + 3, before[2] + 1, before[3] + 3, before[4] + 1)
    assert swop.plain_calls == plain
