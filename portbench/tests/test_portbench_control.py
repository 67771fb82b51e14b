"""The control comes out not correct: each cell at its own size on the
card, with the program's own int8 datapath switched on (`quant="int8"`,
every weight and activation quantized per row: the step below the
configuration's bf16), is judged by the cell's limits and fails one.

Needs the card (`pytest -m gpu portbench/tests/test_portbench_control.py`
on it); at the CPU's tiny sizes a few dozen tokens do not separate the
two datapaths, so there it skips."""
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size, on the card")
    from portbench import harness
    res, _, found = harness.run_cell(cell, 2**31 + 4242, 20.0, False, quant="int8")
    assert not found
    assert res["checked"]["tokens"]["value"] > 0
    assert not res["correct"], res["checked"]
