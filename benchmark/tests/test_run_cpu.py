"""Whole runs of the cells at a small size on the CPU: the result's shape,
and each fault a cell can have, planted in the program underneath the
timed path, turning ``correct`` false. (The look for a card is skipped:
``harness.run`` is called with the CPU; there the detect loop and the
train step run eagerly.)"""

import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_cell
from multibox_tpu_torch import inference
from multibox_tpu_torch.train import loop as train_loop
from multibox_tpu_torch.train import state as train_state

SEED = 2 ** 31 + 11


def run(name, seconds=0.5):
    torch.manual_seed(0)
    return harness.run(tiny_cell(name), SEED, seconds, False, torch.device("cpu"),
                       time.perf_counter())


@pytest.fixture(scope="module")
def sound():
    return {name: run(name) for name in ("multibox_inception_v3.detect_b4096",
                                         "multibox_inception_v3.train_b32")}


def test_result_line(sound):
    for name, r in sound.items():
        assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
        cell = harness.load_cell(name)
        assert set(r["metrics"]) == set(cell.end_to_end)
        assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in r["metrics"].values())
        assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
        assert list(r["checks"]) == list(cell.limits)
        assert r["attempted"] > 0 and r["failed"] == 0
        json.dumps(r)


def _pack_altered(pack):
    def altered(det):
        out = pack(det).clone()
        out[0, 0, 0] = (out[0, 0, 0] + 0.05) % 1.0  # one box of the batch moved
        return out
    return altered


def _pack_half(pack):
    def half(det):
        out = pack(det).clone()
        out[out.shape[0] // 2:, :, 6] = 0  # the second half's detections dropped
        return out
    return half


def _half_rows(device_batch):
    def half(self, batch, gen):
        out = device_batch(self, batch, gen)
        B = out["images"].shape[0] // 2
        return {k: v[:B] for k, v in out.items()}
    return half


FAULTS = {
    "detect_answer_altered": ("multibox_inception_v3.detect_b4096", "box_gap",
                              lambda mp: mp.setattr(inference, "_pack_dets",
                                                    _pack_altered(inference._pack_dets))),
    "detect_half_the_batch_dropped": ("multibox_inception_v3.detect_b4096", "choice_gap",
                                      lambda mp: mp.setattr(inference, "_pack_dets",
                                                            _pack_half(inference._pack_dets))),
    "train_state_unchanged": ("multibox_inception_v3.train_b32", "change_median_gap", lambda mp: (
        mp.setattr(train_state.Optimizer, "apply_staged", lambda *a, **k: None),
        mp.setattr(train_state, "ema_update_staged", lambda *a, **k: None))),
    "train_half_the_batch": ("multibox_inception_v3.train_b32", "grad_median_gap", lambda mp: mp.setattr(
        train_loop.AugmentedTrainStep, "device_batch",
        _half_rows(train_loop.AugmentedTrainStep.device_batch))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_is_not_correct(fault, sound, monkeypatch):
    name, number, plant = FAULTS[fault]
    plant(monkeypatch)
    r = run(name)
    assert r["correct"] is False
    got, base = r["checks"][number]["value"], sound[name]["checks"][number]["value"]
    assert got > r["checks"][number]["limit"] and got > 3 * base
