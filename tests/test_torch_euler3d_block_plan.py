"""The 3D operator's plan on the CPU (``ops/euler3d_operator.py``:
``operator_plan``, ``interface_of_thread`` and ``interface_point``, the
indexing of csrc/euler3d_operator.cu's interface and volume passes
mirrored): the interface pass computes every interface point of the grid
exactly once, each side from the element's state (or the halo at a panel
or tile edge, the mirror at the ground and the lid), into the rows at its
own index, and the volume pass reads, for both elements of an interface,
those same rows, each on its own side. The kernels themselves are held
against their plain version on the card (``tests/test_torch_kernel_cuda.py``,
``chip_smoke.py``)."""

import collections

import pytest

from wxfactory_tpu_torch.ops.euler3d_operator import interface_of_thread, interface_point, operator_plan

# (nel_h, nel_v, s, npanel): whole spheres and tiles (npanel 1), s = 2..6.
SHAPES = [(20, 20, 3, 6), (7, 3, 3, 6), (5, 3, 2, 6), (12, 3, 2, 6), (3, 2, 5, 6), (2, 8, 6, 6), (4, 4, 4, 6),
          (10, 20, 3, 1), (7, 3, 3, 1)]


def _faces(elem):
    """The interfaces of an element's faces W, E, S, N, D, U, and the side
    (L or R) the element is on."""
    p, k, y, x = elem
    return [((0, p, k, y, x), "R"), ((0, p, k, y, x + 1), "L"), ((1, p, k, y, x), "R"),
            ((1, p, k, y + 1, x), "L"), ((2, p, k, y, x), "R"), ((2, p, k + 1, y, x), "L")]


def _elements(nel_h, nel_v, npanel):
    return {(p, k, y, x) for p in range(npanel) for k in range(nel_v) for y in range(nel_h) for x in range(nel_h)}


@pytest.mark.parametrize("nel_h,nel_v,s,npanel", SHAPES)
def test_every_interface_point_computed_once(nel_h, nel_v, s, npanel):
    plan = operator_plan(nel_h, nel_v, s, npanel)
    elements = _elements(nel_h, nel_v, npanel)
    seen = set()
    for i in range(plan["points"]):
        itf, k, sides = interface_of_thread(i, nel_h, nel_v, s, npanel)
        # Its rows at its own index, and no other thread's.
        assert interface_point(itf, nel_h, nel_v, s, npanel) + k == i
        assert (itf, k) not in seen
        seen.add((itf, k))
        d, p, kz, y, x = itf
        left = (p, kz, y, x - 1) if d == 0 else ((p, kz, y - 1, x) if d == 1 else (p, kz - 1, y, x))
        for elem, side in ((left, sides[0]), ((p, kz, y, x), sides[1])):
            edge = "mirror" if d == 2 else "halo"
            assert side == ("device" if elem in elements else edge), (itf, elem, side)
    want = {(itf, k) for e in elements for itf, _ in _faces(e) for k in range(s * s)}
    assert seen == want
    assert plan["interface_blocks"] * 128 >= plan["points"] > (plan["interface_blocks"] - 1) * 128


@pytest.mark.parametrize("nel_h,nel_v,s,npanel", SHAPES)
def test_both_elements_read_the_same_rows(nel_h, nel_v, s, npanel):
    plan = operator_plan(nel_h, nel_v, s, npanel)
    readers = collections.defaultdict(set)
    for elem in _elements(nel_h, nel_v, npanel):
        for itf, side in _faces(elem):
            i = interface_point(itf, nel_h, nel_v, s, npanel)
            assert 0 <= i < plan["points"] and i % (s * s) == 0
            # The thread that writes these rows computes this interface.
            assert interface_of_thread(i, nel_h, nel_v, s, npanel)[0] == itf
            readers[i].add((elem, side))
    for i, who in readers.items():
        sides = sorted(side for _, side in who)
        # Two elements, one a side, or one at a panel edge, the ground or the lid.
        assert sides in (["L", "R"], ["L"], ["R"]), (i, who)


def test_launch_geometry_of_the_main_path():
    # dcmip31 at 20 x 20 x 20, s = 3: 1,360,800 interface points in 10,632
    # blocks of 128 threads; 5,334 volume blocks of 9 elements; 12.2 M words
    # of interface rows (98 MB in float64).
    plan = operator_plan(20, 20, 3, 6)
    assert (plan["points"], plan["interface_blocks"], plan["volume_blocks"]) == (1360800, 10632, 5334)
    assert plan["rows_words"] == 12247200
