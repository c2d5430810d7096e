"""The port's SW operator CUDA kernel against its plain torch version, on
the card. Needs a CUDA device and nvcc, and skips without them. On a GPU
machine run it without tests/conftest.py (which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Tolerances and scales: wxfactory_tpu_torch/kernels/check.py. The check of
record at the main path's shapes is chip_smoke.py."""

import pytest
import torch

from wxfactory_tpu_torch.kernels.check import case6_inputs, compare_sw_operator
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
