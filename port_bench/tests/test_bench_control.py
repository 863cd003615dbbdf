"""The lower-precision control comes out not correct, the program
correct, under each cell's own limits.

The control is the plain reference with every product's operands rounded
to fp8 e4m3 (per-tensor scale; reference/precision.py), put in the
program's place: served replies restored by it, or its three training
steps, compared with the float32 reference as the program is. On the card
it was read at each cell's own size on a dozen seeds (port_bench.calibrate;
PERF.md gives the readings). Here it runs at the rehearsal's size on the
CPU (rehearse.SHRINK), where the control has to fail one of the cell's
numbers and the program none."""

import pytest

from port_bench import manifest, rehearse

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    out = rehearse.rehearse(cell, 2 ** 31 + 23, 1.0, control=True)
    limits = manifest.cell(cell)["limits"]
    control = out["raw"]["control_checks"]
    assert any(control[k] > v["limit"] for k, v in limits.items()), control
    assert out["line"]["correct"] is True, out["line"]["checks"]
