"""The port's ``kinetics.density.Density`` unit conversions against the
JAX package's, on the cases of ``tests/test_kinetics.py::TestDensityUnits``
(the reference's vendored Density, wdensity.py:440-627).

Host numpy code in both: after every conversion the grids, ``delta``,
``origin`` and units are equal bit for bit, the unit tables are equal,
and the error paths raise the same type with the same message. The JAX
test's fixed values are checked on the port."""

import numpy as np
import pytest

from basicrta_tpu.kinetics import density as jd

from basicrta_torch.kinetics import density as td


def _pair(value, is_density=True, unit="Angstrom^{-3}", shape=4):
    edges = [np.linspace(0, shape, shape + 1)] * 3
    grid = np.full((shape,) * 3, value, np.float64)
    kw = dict(is_density=True, density_unit=unit) if is_density else {}
    return (td.Density(grid.copy(), edges, **kw),
            jd.Density(grid.copy(), edges, **kw))


def _same(a, b):
    np.testing.assert_array_equal(a.grid, b.grid)
    np.testing.assert_array_equal(a.delta, b.delta)
    np.testing.assert_array_equal(a.origin, b.origin)
    assert (a.is_density, a.length_unit, a.density_unit) == \
        (b.is_density, b.length_unit, b.density_unit)


def test_unit_tables_equal():
    assert td.DENSITY_UNITS == jd.DENSITY_UNITS
    assert td.LENGTH_UNITS == jd.LENGTH_UNITS


@pytest.mark.parametrize("path,value,want", [
    (["water", "Angstrom^{-3}"], 0.0334, 0.0334),
    (["nm^{-3}"], 1.0, 1000.0),
    (["nm^{-3}", "Molar"], 1.0, 1660.54),
    (["nm^{-3}", "Molar", "TIP4P", "Angstrom^{-3}"], 1.0, 1.0),
    (["SPC", "TIP3P", "water"], 0.05, None),
])
def test_convert_density_equal(path, value, want):
    a, b = _pair(value)
    for unit in path:
        a.convert_density(unit)
        b.convert_density(unit)
        _same(a, b)
    if want is not None:
        assert a.grid.flat[0] == pytest.approx(want, rel=1e-3)
    c, _ = _pair(0.0334)
    assert c.convert_density("water").grid.flat[0] == pytest.approx(
        1.0, abs=0.01)


def test_convert_length_equal():
    a, b = _pair(1.0)
    for unit, delta in (("nm", 0.1), ("Angstrom", 1.0)):
        a.convert_length(unit)
        b.convert_length(unit)
        _same(a, b)
        assert a.delta[0] == pytest.approx(delta) and a.length_unit == unit


def test_make_density_and_errors_alike():
    a, b = _pair(1.0, is_density=False, shape=2)
    msgs = []
    for d in (a, b):
        with pytest.raises(RuntimeError) as e:
            d.convert_density("water")
        msgs.append(str(e.value))
    a.make_density()
    b.make_density()
    _same(a, b)
    for d in (a, b):
        with pytest.raises(ValueError) as e:
            d.convert_density("parsecs^{-3}")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[2] == msgs[3]
