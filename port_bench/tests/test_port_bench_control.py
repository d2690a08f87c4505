"""The control of each cell at the cell's own size, on the card: the
nearest precision below the configuration's in the program's place
comes out not correct on three seeds (``-m cuda``, on the chip)."""
import pytest
import torch

from port_bench import registry
from port_bench.control import readings

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_at_the_cells_size_is_not_correct(name):
    cell = registry.Cell(name)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} CUDA device(s)")
    lines = list(readings(name, "control", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13], 3.0,
                          cell=cell))
    assert [line["correct"] for line in lines] == [False] * 3, [l["numbers"] for l in lines]
