"""The control on the card: the reference put in the program's place and
computed in the precision below the configuration's (float32 with TF32
on, for a float32 configuration with TF32 off) fails the cell's limits,
while the program passes them, on three seeds, at a size a test run can
hold. Run on the card with ``python -m pytest portbench/tests -m cuda``."""
import pytest
import torch

from portbench.tests import tiny
from portbench import check, harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 7, 4_000_000_003])
def test_the_control_fails_where_the_program_passes(card, seed):
    cell = tiny.tiny_cell()
    prep = harness.prepare(cell, seed, card)
    harness.free(prep, card)
    ref = check.run_reference(cell.config, cell.traffic, seed, prep.data,
                              card)
    program = check.gaps(prep.program, ref)
    assert all(program[k] <= cell.limits[k] for k in check.NUMBERS), program
    control = check.gaps(check.run_reference(
        cell.config, cell.traffic, seed, prep.data, card,
        dtype=torch.float32, tf32=True), ref)
    assert any(control[k] > cell.limits[k] for k in check.NUMBERS), control
