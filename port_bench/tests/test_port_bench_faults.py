"""A run with its timed path broken underneath, or with the control in
the program's place, comes out not correct.

Each test skips the harness's look for a card (a CPU device and the cell
at a CPU-sized frame) and drives the rest of a run: set-up, window, the
reference and the judgement under the cell's committed limits, with one
fault planted in the program's timed path or the control in its place. A
sound predict run of the same size comes out correct, so the limits, not
the size, decide there. (The train cells' limits were set from an R101
on the card; a sound R50 on the CPU at this size reads close to them, so
only their faults and control are checked here.)"""
import pytest

from port_bench.control import readings

SEED = 2 ** 31 + 101
PREDICT = ["r50-predict-b32", "r50-predict-int8-b32"]


def _one(name, variant, cell):
    return next(readings(name, variant, [SEED], 1.0, device="cpu", cell=cell))


@pytest.mark.parametrize("name", PREDICT)
@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_predict_fault_is_not_correct(name, fault, cell_at_small_size):
    line = _one(name, fault, cell_at_small_size(name))
    assert line["correct"] is False, line["numbers"]


@pytest.mark.parametrize("name,fault", [
    ("r101-train-s1-b16", "half_batch"), ("r101-train-s1-b16", "frozen"),
    ("r101-train-s1-dp4", "half_batch"), ("r101-train-s1-dp4", "frozen"),
    ("r101-train-s1-dp4", "no_exchange")])
def test_train_fault_is_not_correct(name, fault, cell_at_small_size):
    """On four CPU ranks over gloo for the data axis's cell."""
    line = _one(name, fault, cell_at_small_size(name))
    assert line["correct"] is False, line["numbers"]


@pytest.mark.parametrize("name", PREDICT)
def test_control_is_not_correct(name, cell_at_small_size):
    """The control (the program's int8 path for the bfloat16 cell, the
    reference at int4 for the int8 cell) at this size."""
    line = _one(name, "control", cell_at_small_size(name))
    assert line["correct"] is False, line["numbers"]


def test_train_control_is_not_correct(cell_at_small_size):
    """The reference's steps at float8 in the program's place."""
    name = "r101-train-s1-b16"
    line = _one(name, "control", cell_at_small_size(name))
    assert line["correct"] is False, line["numbers"]


@pytest.mark.parametrize("name", PREDICT)
def test_sound_run_is_correct(name, cell_at_small_size):
    line = _one(name, "sound", cell_at_small_size(name))
    assert line["correct"] is True, line["numbers"]
