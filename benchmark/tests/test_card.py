"""On the card, at each cell's own sizes: the control (the reference in the
next precision below the configuration's) and each fault, judged as a run's
outputs are, fail the cell's committed limits on three seeds; in the detect
cells so do fp8 products (the program's precision but for the
convolutions' operands, read in fp8).

    python3 -m pytest -q -m cuda benchmark/tests/test_card.py
"""

import pytest
import torch

from benchmark import calibrate, check, harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
CELLS = ["multibox_inception_v3.detect_b4096", "multibox_inception_v3.train_b32",
         "ssd_inception_v3.train_b32", "ssd_inception_v3.detect_b2048"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cells' full sizes")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail(name, card):
    cell = harness.load_cell(name)
    read = calibrate.detect_readings if cell.traffic["kind"] == "detect" \
        else calibrate.train_readings
    for seed in SEEDS:
        got = read(cell, seed, card)
        assert not check.passed(check.judge(got["control"], cell.limits)), (seed, got)
        if cell.traffic["kind"] == "detect":
            assert not check.passed(check.judge(got["fp8_products"], cell.limits)), (seed, got)
        for fault, numbers in got["faults"].items():
            if fault != "reference_itself":
                assert not check.passed(check.judge(numbers, cell.limits)), (seed, fault)
        torch.cuda.empty_cache()
