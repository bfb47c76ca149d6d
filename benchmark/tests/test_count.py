"""The yardstick's counts: the model's operations against PyTorch's own
count of the reference model, and the bytes and operations of each
kernel's bound on cases worked by hand."""

import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import count, inputs
from benchmark.reference import model as ref_model

MULTIBOX = {"input_size": 107, "head_type": "multibox", "num_priors": 16, "num_classes": 1,
            "bottleneck_features": 96, "weights": {"location_std": 0.06, "confidence_std": 2.4}}
SSD = {"input_size": 107, "head_type": "ssd", "num_priors": None, "num_classes": 1,
       "ssd_endpoints": ["Mixed_5d", "Mixed_6e", "Mixed_7c"], "ssd_priors_per_cell": 6,
       "weights": {"location_std": 1.0, "confidence_std": 2.4}}
SSD["num_priors"] = 6 * sum(ref_model.grid_size(107, e) ** 2 for e in SSD["ssd_endpoints"])


@pytest.mark.parametrize("model", [MULTIBOX, SSD], ids=["multibox", "ssd"])
def test_model_flops_against_the_counter(model):
    params, stats = inputs.make_weights(model, 0, "cpu")
    x = torch.rand(2, 107, 107, 3) * 2 - 1
    with FlopCounterMode(display=False) as fwd:
        with torch.no_grad():
            ref_model.forward(model, params, stats, x)
    assert fwd.get_total_flops() == pytest.approx(2 * count.model_flops(model), rel=1e-12)
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    with FlopCounterMode(display=False) as step:
        loc, conf = ref_model.forward(model, leaves, stats, x, train=True, new_stats={})
        (loc.sum() + conf.sum()).backward()
    assert step.get_total_flops() == pytest.approx(2 * count.model_flops(model, train=True),
                                                   rel=1e-12)


def test_full_size_forward():
    """Inception-v3 at 299 is 5.7 G multiply-adds (arXiv:1512.00567 counts
    about 5 G), the MultiBox head 0.02 G more."""
    model = dict(MULTIBOX, input_size=299, num_priors=256)
    fwd = count.model_flops(model)
    assert 11.3e9 < fwd < 11.6e9
    assert count.model_flops(model, train=True) == pytest.approx(3 * fwd, rel=0.01)


def test_matmul_bound():
    # 32 x 6144 x 1024: bytes (32*6144 + 6144*1024 + 32*1024) * 4 + 1024 * 4
    nbytes = (32 * 6144 + 6144 * 1024 + 32 * 1024) * 4 + 4096
    assert count.matmul_bound_s(32, 6144, 1024) == pytest.approx(nbytes / 3.35e12)
    big = count.matmul_bound_s(4096, 4096, 4096)
    assert big == pytest.approx(2 * 4096 ** 3 / 67e12)
    shapes = count.head_matmuls({"input_size": 299, "num_priors": 256}, 32)
    assert shapes == [(32 * 64, 2048, 96), (32, 6144, 1024), (32, 6144, 256)]


def test_nms_work_by_hand():
    boxes = np.array([[[0, 0, 1, 1], [0, 0, 1, 0.9], [0, 0, 0.1, 0.1], [0.5, 0.5, 0.6, 0.6]]],
                     np.float32)
    scores = np.array([[0.9, 0.8, 0.7, 0.01]], np.float32)
    # 0 kept; 1 suppressed by 0 (1 test); 2 kept (1 test); 3 below the threshold
    assert count.nms_work(boxes, scores, 10, 0.5, 0.05) == (3, 2)
    # k = 2: the walk stops at the second box kept
    assert count.nms_work(boxes, scores, 2, 0.5, 0.05) == (3, 2)
    assert count.nms_work(boxes, scores, 1, 0.5, 0.05) == (1, 0)
    nbytes = 4 * 4 + 3 * 16 + 10 * 8
    assert count.nms_bound_s(boxes, scores, 10, 0.5, 0.05) == pytest.approx(nbytes / 3.35e12)


def test_match_bound():
    live = np.array([3, 16, 0, 1])
    nbytes = 256 * 16 + 4 * 16 * 16 + 4 * 4 + 4 * 16 * 4
    flops = count.IOU_FLOPS * 20 * 256
    assert count.match_bound_s(live, 16, 256) == pytest.approx(
        max(nbytes / 3.35e12, flops / 67e12))
    assert math.isclose(count.bound_s(1e6, 0), 1e6 / 3.35e12)


def test_busy_time_is_the_union_of_device_work():
    from benchmark import devtrace

    E = devtrace.Event
    trace = devtrace.Trace(
        device=[E(10, 20, "k1"), E(15, 30, "k2"), E(50, 60, "memcpy")],
        host=[E(0, 100, "cudaGraphLaunch"), E(30, 50, "bench.feed")], window=E(0, 100, "w"))
    busy, window = devtrace.busy_and_window_s(trace)
    assert (busy, window) == (30e-6, 100e-6)
    assert devtrace.kernel_time(trace, r"^k\d") == (25e-6, 2)
    b = devtrace.breakdown(trace)
    assert b["device_ops"][0] == ["k2", 15e-6]
    assert b["idle_gaps"][0] == ["cudaGraphLaunch", 40e-6]  # 60-100, the innermost span
    assert ["bench.feed", 20e-6] in b["idle_gaps"]
