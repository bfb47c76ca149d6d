"""The readers of the program's spans and capture counters, on a made-up
trace: a span's time less its ``.wait`` children inside it, over the traced
batches or steps; nothing read from a program without them."""

import pytest

from benchmark import devtrace, harness
from multibox_tpu_torch import graphs

E = devtrace.Event


def trace(*host):
    return devtrace.Trace([E(0.0, 1.0, "kernel")], list(host), E(0.0, 5000.0, "bench.stretch"))


class Ctx:
    def __init__(self, tr, traced, kind="detect"):
        self.trace, self.traced, self.traffic = tr, traced, {"kind": kind}


# Two groups, each span holding its wait; a wait outside any span and
# another span's events are not subtracted.
CASES = {
    "stage_ms.detect": ("graphs.stage", "graphs.stage.wait"),
    "stage_ms.train": ("graphs.stage", "graphs.stage.wait"),
    "drain_ms.detect": ("detect.drain", "detect.drain.wait"),
}


@pytest.mark.parametrize("metric", sorted(CASES))
def test_a_span_less_its_waits_over_the_traced_batches(metric):
    parent, child = CASES[metric]
    tr = trace(E(0, 1000, parent), E(100, 400, child),
               E(2000, 2600, parent), E(2000, 2100, child),
               E(3000, 3900, child), E(4000, 4500, "detect.loop"))
    # (1000 - 300 + 600 - 100) us over 2 batches
    assert harness.load_reader(harness.ROOT, metric)(Ctx(tr, [0, 1])) == pytest.approx(0.6)
    # one traced batch: the sum
    assert harness.load_reader(harness.ROOT, metric)(Ctx(tr, [0])) == pytest.approx(1.2)


@pytest.mark.parametrize("metric", sorted(CASES))
def test_nothing_is_read_from_a_program_without_the_spans(metric):
    tr = trace(E(0, 1000, "bench.feed"), E(0, 500, "aten::copy_"))
    assert harness.load_reader(harness.ROOT, metric)(Ctx(tr, [0])) is None


@pytest.mark.parametrize("kind", ["detect", "train"])
def test_capture_s_reads_the_cells_own_owner(kind, monkeypatch):
    counts = {"detect": {"captures": 1, "warmup_s": 2.5, "capture_s": 0.25},
              "train": {"captures": 1, "warmup_s": 4.0, "capture_s": 1.5},
              "other": {"captures": 3, "warmup_s": 9.0, "capture_s": 9.0}}
    monkeypatch.setattr(graphs, "capture_counts", lambda: counts)
    read = harness.load_reader(harness.ROOT, "capture_s")
    assert read(Ctx(trace(), [0], kind)) == pytest.approx(sum(
        counts[kind][k] for k in ("warmup_s", "capture_s")))
    monkeypatch.setattr(graphs, "capture_counts", lambda: {"other": counts["other"]})
    assert read(Ctx(trace(), [0], kind)) is None
    monkeypatch.delattr(graphs, "capture_counts")  # the program before the counters
    assert read(Ctx(trace(), [0], kind)) is None
