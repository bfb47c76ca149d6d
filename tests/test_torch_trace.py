"""The port's host spans (``multibox_tpu_torch.utils.spans``) and the graphs'
capture counters, on the CPU.

- With no profiler a span is one shared null context; under
  ``torch.profiler`` it is a ``record_function`` range of its name.
- The eager detect loop (the graphed loop's test's size: 75 px, 16 priors,
  5 batches of 2, the last group short at K = 3) under the profiler: one
  ``detect.loop``, a ``detect.dispatch`` and a ``detect.drain`` a group, a
  ``detect.drain.wait`` a fetch, a ``prefetch.wait`` a batch and one at the
  end; each span inside its parent.
- ``Prefetcher`` (the detect loop's, the train feed's) waits inside
  ``prefetch.wait``.
- The package's spans are the ten its loops name, none in the
  benchmark's ``bench.`` namespace.

The graphed spans (``graphs.stage``, ``graphs.replay``, ``train.group``)
and the capture counts are tested on the card, in ``test_torch_graphs.py``.
"""

import ast
import contextlib
import os
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from multibox_tpu_torch import graphs
from multibox_tpu_torch import inference as tinf
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.data.pipeline import Prefetcher
from multibox_tpu_torch.utils.spans import span
from tests.test_torch_graphs import DETECT, SPANS, detect_batches
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "multibox_tpu_torch")


def spans_of(prof):
    """``{name: [(start_us, end_us), ...]}`` of the program's spans, in order."""
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in SPANS:
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return {k: sorted(v) for k, v in out.items()}


def test_a_span_is_one_null_object_without_a_profiler():
    objects = {id(span(name)) for name in sorted(SPANS)}
    assert len(objects) == 1
    assert isinstance(span("detect.loop"), contextlib.nullcontext)


def test_a_span_is_recorded_only_while_a_profiler_records():
    off = span("detect.loop")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = span("detect.loop")
        with on:
            torch.ones(3).sum()
    assert on is not off and span("detect.loop") is off
    assert list(spans_of(prof)) == ["detect.loop"]


@pytest.fixture(scope="module")
def detect_spans():
    """The spans of one eager detect loop at K = 1 and at K = 3."""
    rng = np.random.default_rng(0)
    priors = np.sort(rng.uniform(0.05, 0.95, (16, 2, 2)).astype(np.float32),
                     axis=1).reshape(16, 4)
    data = detect_batches(np.random.default_rng(1), batches=5)
    out = {}
    for K in (1, 3):
        cfg = Config(**dict(DETECT, steps_per_host_transfer=K))
        model = tinf.build_model(cfg, 16, device="cpu")
        variables = model.init_variables(torch.Generator().manual_seed(0))
        fns = tinf.make_detect_loop_fns(cfg, priors, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            results = tinf.run_detect_loop(cfg, variables, data, priors, fns=fns)
        assert len(results) == 9  # 4 full batches of 2 and one valid image
        out[K] = spans_of(prof)
    return out


# K: (groups, fetches); 5 batches, the short last group at K = 3 runs
# batch by batch
GROUPS = {1: (5, 5), 3: (2, 3)}


@pytest.mark.parametrize("K", sorted(GROUPS), ids=lambda k: f"K{k}")
def test_the_detect_loop_has_a_dispatch_and_a_drain_a_group(detect_spans, K):
    got = {name: len(v) for name, v in detect_spans[K].items()}
    groups, fetches = GROUPS[K]
    assert got == {"detect.loop": 1, "detect.dispatch": groups, "detect.drain": groups,
                   "detect.drain.wait": fetches, "prefetch.wait": 5 + 1}


@pytest.mark.parametrize("child,parent", [
    ("detect.dispatch", "detect.loop"), ("detect.drain", "detect.loop"),
    ("detect.drain.wait", "detect.drain"), ("prefetch.wait", "detect.loop")])
def test_each_detect_span_lies_inside_its_parent(detect_spans, child, parent):
    for K, spans in detect_spans.items():
        for s, t in spans[child]:
            assert any(a <= s and t <= b for a, b in spans[parent]), (K, child, s, t)
    # the drain of group N follows the dispatch of group N + 1 (1-deep pipeline)
    if child == "detect.drain":
        for K, spans in detect_spans.items():
            d, r = spans["detect.dispatch"], spans["detect.drain"]
            assert all(d[n + 1][1] <= r[n][0] for n in range(len(d) - 1)), K


def test_prefetcher_waits_inside_its_span():
    def slow():
        for n in range(3):
            time.sleep(0.05)
            yield n

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert list(Prefetcher(slow(), depth=2)) == [0, 1, 2]
    waits = spans_of(prof)["prefetch.wait"]
    assert len(waits) == 4  # three items and the end
    # blocked on an empty queue while the producer sleeps
    assert all(t - s >= 30e3 for s, t in waits[:3]), waits


def test_the_package_names_the_ten_spans_and_none_of_the_benchmarks():
    names = set()
    for dirpath, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    tree = ast.parse(fh.read())
                names |= {node.args[0].value for node in ast.walk(tree)
                          if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span"
                          and node.args and isinstance(node.args[0], ast.Constant)}
    assert names == SPANS
    assert not any(n.startswith("bench.") for n in names)


def test_capture_counts_are_a_copy_and_reset(monkeypatch):
    monkeypatch.setattr(graphs, "CAPTURES", {})
    assert graphs.capture_counts() == {}
    graphs.CAPTURES["detect"] = {"captures": 1, "warmup_s": 1.5, "capture_s": 0.5}
    counts = graphs.capture_counts()
    counts["detect"]["captures"] = 7
    assert graphs.capture_counts() == {"detect": {"captures": 1, "warmup_s": 1.5,
                                                  "capture_s": 0.5}}
    graphs.reset_capture_counts()
    assert graphs.capture_counts() == {}
