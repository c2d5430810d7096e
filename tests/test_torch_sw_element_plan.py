"""The premise and the indexing of the shallow-water element kernel's
sum-factorised products (csrc/sw_element.cuh), on the CPU.

The kernel reads the operator's dense extrapolation, derivative and
correction blocks (EE, DD, CC of ``SWConstants.ops``) only at one position
of each 1D factor entry, and sums each face point, derivative and
correction over the terms that a Kronecker product with the identity
leaves non-zero. That gives the dense products' bits for a finite state
only if

* the dense blocks ARE those Kronecker products, zero pattern included, so
  every entry the kernel reads is the factor every other entry of the same
  factor equals (exact equality, ``np.array_equal``), and
* the kernel's terms (``ops/sw_operator.py::element_plan``, the numpy
  mirror of its indexing) are exactly the dense columns' non-zero entries,
  in the dense loops' ascending order; every other entry is zero.

Applied in float64, the plan matches the dense products to 1e-15 of each
output's scale (the largest sum of its terms' magnitudes): the two sum
the same terms, in another order where BLAS reorders.
"""

import numpy as np
import pytest

from wxfactory_tpu.ops.dfr import make_dfr_operators as j_make_dfr_operators
from wxfactory_tpu_torch.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu_torch.ops import sw_operator as swop
from wxfactory_tpu_torch.ops.dfr import make_dfr_operators

SOLPTS = range(2, 9)


def _blocks(s: int):
    """(ops flat, EE, DD, CC) of ``build_constants`` at (nel=2, s), float64."""
    geom = make_cubed_sphere_2d(2, s)
    con = swop.build_constants(make_dfr_operators(s), make_metric_2d(geom), 2)
    flat = con.ops.numpy()
    return flat, con.ee.numpy(), con.dd.numpy(), con.cc.numpy()


def _kronecker_blocks(s: int):
    """EE, DD, CC built from the 1D factors of ops/dfr.py by Kronecker
    products with the identity (faces W, E, S, N; node ky*s + kx)."""
    o = make_dfr_operators(s)
    eye = np.eye(s)
    en, ep, d = o.extrap_neg, o.extrap_pos, o.diff_solpt
    cn, cp = o.correction[:, 0], o.correction[:, 1]
    ee = np.concatenate([np.kron(eye, en[None, :]).T, np.kron(eye, ep[None, :]).T,
                         np.kron(en[None, :], eye).T, np.kron(ep[None, :], eye).T], axis=1)
    dd = np.concatenate([np.kron(eye, d).T, np.kron(d, eye).T], axis=0)
    cc = np.concatenate([np.kron(eye, cn[None, :]), np.kron(eye, cp[None, :]),
                         np.kron(cn[None, :], eye), np.kron(cp[None, :], eye)], axis=0)
    return ee, dd, cc


@pytest.mark.parametrize("s", SOLPTS)
def test_dense_blocks_are_kronecker_products_of_the_1d_factors(s):
    _, ee, dd, cc = _blocks(s)
    kee, kdd, kcc = _kronecker_blocks(s)
    assert np.array_equal(ee, kee)
    assert np.array_equal(dd, kdd)
    assert np.array_equal(cc, kcc)
    assert np.array_equal(ee != 0, kee != 0) and np.array_equal(dd != 0, kdd != 0)


@pytest.mark.parametrize("s", SOLPTS)
def test_1d_factors_equal_the_jax_package_s(s):
    o, j = make_dfr_operators(s), j_make_dfr_operators(s)
    for name in ("extrap_neg", "extrap_pos", "diff_solpt", "correction"):
        assert np.array_equal(getattr(o, name), np.asarray(getattr(j, name))), name


def _dense_terms(column: np.ndarray, rows: np.ndarray, weights: np.ndarray):
    """The plan's rows of one dense column are ascending, its weights are
    the column's entries there, and every other entry is exactly zero."""
    assert np.all(np.diff(rows) > 0), "the plan's terms are not in the dense loop's order"
    assert np.array_equal(weights, column[rows])
    rest = np.ones(column.shape[0], bool)
    rest[rows] = False
    assert np.all(column[rest] == 0.0)


@pytest.mark.parametrize("s", SOLPTS)
def test_element_plan_takes_exactly_the_dense_non_zero_terms_in_order(s):
    flat, ee, dd, cc = _blocks(s)
    plan = swop.element_plan(s)
    fac = flat[plan["factors"]]
    assert fac.shape == (8 * s + 2 * s * s,)
    for fi in range(4 * s):
        _dense_terms(ee[:, fi], plan["face_nodes"][fi], fac[plan["face_factor"][fi]])
    for j in range(s * s):
        _dense_terms(dd[:, j], plan["div_terms"][j], fac[plan["div_factor"][j]])
        _dense_terms(cc[:, j], plan["corr_faces"][j], fac[plan["corr_factor"][j]])


@pytest.mark.parametrize("s", SOLPTS)
def test_element_plan_applied_matches_the_dense_products(s):
    flat, ee, dd, cc = _blocks(s)
    plan = swop.element_plan(s)
    fac = flat[plan["factors"]]
    rng = np.random.default_rng(s)
    q = rng.standard_normal((64, s * s))
    f = rng.standard_normal((64, 2 * s * s))
    fl = rng.standard_normal((64, 4 * s))

    def ordered(values, idx, w):
        terms = values[:, idx] * w  # (n, outputs, terms)
        acc = np.zeros(terms.shape[:2])
        for t in range(terms.shape[2]):
            acc = acc + terms[:, :, t]
        return acc, np.abs(terms).sum(axis=2).max()

    for got_scale, want in (
            (ordered(q, plan["face_nodes"], fac[plan["face_factor"]]), q @ ee),
            (ordered(f, plan["div_terms"], fac[plan["div_factor"]]), f @ dd),
            (ordered(fl, plan["corr_faces"], fac[plan["corr_factor"]]), fl @ cc)):
        got, scale = got_scale
        assert np.abs(got - want).max() <= 1e-15 * scale
