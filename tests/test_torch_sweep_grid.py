"""The port's SweepGrid against cimba_tpu.sweep.SweepGrid.

``rows(reps_per_cell)`` of mg1's and tandem's grids: every leaf of the
experiment array equal value for value and of the same dtype (f64
parameters, i32 ``n_objects``), the cell ids, cells and labels equal;
a ragged grid raises naming its cell, as the reference's does.
"""

import numpy as np
import pytest
import torch

from cimba_tpu.models import mg1 as jmg1
from cimba_tpu.models import tandem as jtandem
from cimba_tpu.sweep import SweepGrid as JGrid
from cimba_tpu_torch.models import mg1 as tmg1
from cimba_tpu_torch.models import tandem as ttandem
from cimba_tpu_torch.sweep import SweepGrid as TGrid

torch.set_num_threads(1)


@pytest.mark.parametrize("name,args", [
    ("mg1", (2000,)), ("mg1", (50, (0.5, 2.0), (0.6, 0.9))),
    ("tandem", (400,)), ("tandem", (40, (0.4,), (0.1, 0.25, 0.3))),
])
@pytest.mark.parametrize("reps", [1, 7])
def test_rows_match_reference(name, args, reps):
    jmod, tmod = (jmg1, tmg1) if name == "mg1" else (jtandem, ttandem)
    jg, tg = jmod.sweep_grid(*args), tmod.sweep_grid(*args)
    (jp, jids), (tp, tids) = jg.rows(reps), tg.rows(reps)
    assert isinstance(tp, tuple) and len(tp) == len(jp)
    for a, b in zip(jp, tp):
        a = np.asarray(a)
        assert b.device.type == "cpu" and b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)
    np.testing.assert_array_equal(tids, jids)
    assert tg.n_cells == jg.n_cells and tg.cells() == jg.cells()
    assert [tg.cell_label(i) for i in range(tg.n_cells)] == [
        jg.cell_label(i) for i in range(jg.n_cells)]
    assert repr(tg) == repr(jg)


def test_dtypes_of_the_rows():
    p, _ = ttandem.sweep_grid(400).rows(2)
    assert [x.dtype for x in p] == [torch.float64] * 4 + [torch.int32]
    p, _ = tmg1.sweep_grid(2000).rows(2)
    assert [x.dtype for x in p] == [torch.float64] * 3 + [torch.int32]


def _ragged(grid_cls):
    def row(a):
        return (np.float64(a),) if a < 2 else (np.float64(a), np.int32(1))

    return grid_cls({"a": (1, 2)}, row, name="ragged")


def test_ragged_grid_raises():
    with pytest.raises(ValueError, match="cell 1"):
        _ragged(JGrid).rows(2)
    with pytest.raises(ValueError, match=r"cell 1 \(a=2\)"):
        _ragged(TGrid).rows(2)
    with pytest.raises(ValueError, match="reps_per_cell"):
        ttandem.sweep_grid(10).rows(0)
    with pytest.raises(ValueError, match="axis"):
        TGrid({}, lambda: ())
    with pytest.raises(ValueError, match="no values"):
        TGrid({"a": ()}, lambda a: ())
