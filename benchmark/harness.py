"""One run of one cell: set-up, the measured window, the traced stretch and
its readers, then the check against the reference.

A cell is found by name: ``BENCHMARK.json`` names its configuration file
and its traffic mix, which is ``benchmark/traffic/<traffic>.json``; its
limits are ``benchmark/limits/<cell>.json``; each per-layer metric is read
by ``benchmark/metrics/<metric>.py``. A traffic file's ``kind`` chooses the
path it drives:

- ``detect``: batches of uint8 canvases through the program's detect loop
  (``inference.run_detect_loop`` over graphed functions), from a pool of
  host batches, until the window's end; the rate is every image whose
  detections came back over the whole window, the drain included;
- ``train``: batches of canvases and boxes through the program's train step
  (``train.loop.GraphedTrainStep`` over ``make_augmented_train_step``), fed
  as ``train_from_batches`` feeds it (a prefetch thread, groups of
  ``steps_per_host_transfer``); the rate is every image of every step over
  the whole window, which ends in a synchronize. Checkpoints, logging and
  periodic eval are not in the window.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import check, devtrace, inputs
from benchmark.reference import detect as ref_detect
from benchmark.reference import train as ref_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFETCH = 3  # batches the train feed's thread holds ahead, as ``train_from_batches``'s


class Cell(NamedTuple):
    name: str
    config: Dict  # the configuration file
    traffic: Dict  # the traffic file
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]  # metric -> unit
    limits: Dict[str, Dict]
    chips: int
    root: str


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    workloads = {w["name"]: w for w in manifest["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = workloads[name]
    entry = {c["name"]: c for c in manifest["configs"]}[work["config"]]

    def read(*parts):
        with open(os.path.join(root, *parts)) as f:
            return json.load(f)

    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in manifest["per_layer"]
           if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    return Cell(name, read(entry["file"]), read("benchmark", "traffic", work["traffic"] + ".json"),
                [m["name"] for m in e2e], [m["name"] for m in per], units,
                read("benchmark", "limits", name + ".json"), work["chips"], root)


def load_reader(root: str, metric: str) -> Callable:
    """``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def model_spec(config: Dict) -> Dict:
    """What the reference and the inputs read of a configuration."""
    return {**config["model"], "priors": config["priors"], "weights": config["weights"]}


def port_config(config: Dict, traffic: Dict, seed: int):
    """The program's ``Config`` for this cell: the configuration's model and
    its section for the traffic's kind, the traffic's batch and steps a
    host call, and the run's seed."""
    from multibox_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    values = {**config["model"], **config[traffic["kind"]],
              "batch_size": traffic["batch"],
              "steps_per_host_transfer": traffic["steps_per_host_transfer"], "seed": seed}
    unknown = sorted(set(values) - fields)
    if unknown:
        raise KeyError(f"not fields of the program's Config: {unknown}")
    return Config(**values)


def _until(clock: Callable[[], float], deadline: float, group: int, make: Callable[[int], Dict],
           taken: List[int]):
    """Batches ``make(0), make(1), ...`` until ``deadline``, checked at each
    multiple of ``group``; the indices go into ``taken``."""
    n = 0
    while n % group or clock() < deadline:
        with record_function("bench.feed"):
            batch = make(n)
        taken.append(n)
        yield batch
        n += 1


class DetectCell:
    """The ``detect`` kind."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, clock):
        from multibox_tpu_torch import inference

        self.inference = inference
        self.cell, self.seed, self.device, self.clock = cell, seed, device, clock
        self.traffic = cell.traffic
        self.spec = model_spec(cell.config)
        self.cfg = port_config(cell.config, self.traffic, seed)
        self.priors = inputs.make_priors(self.spec, seed)
        self.params, self.stats = inputs.make_weights(self.spec, seed, device)
        self.pool = inputs.make_detect_pool(self.traffic, seed, device)
        self.variables = {"params": {k: v.clone() for k, v in self.params.items()},
                          "batch_stats": {k: v.clone() for k, v in self.stats.items()}}
        self.fns = inference.make_detect_loop_fns(self.cfg, self.priors, device=device)
        self.results: List[Dict] = []
        self.dispatched = 0

    def batch(self, n: int) -> Dict:
        B = self.traffic["batch"]
        return {"images": self.pool[n % len(self.pool)], "image_ids": list(range(n * B, n * B + B)),
                "batch_valid": B}

    def loop(self, batches) -> List[Dict]:
        return self.inference.run_detect_loop(self.cfg, self.variables, batches, self.priors,
                                              fns=self.fns, device=self.device)

    def setup(self) -> None:
        """One group: the graph of a group is captured at its first use."""
        self.loop(self.batch(n) for n in range(self.traffic["steps_per_host_transfer"]))
        _sync(self.device)

    def window(self, seconds: float) -> Dict[str, float]:
        taken: List[int] = []
        t0 = self.clock()
        self.results = self.loop(_until(self.clock, t0 + seconds,
                                        self.traffic["steps_per_host_transfer"], self.batch, taken))
        t1 = self.clock()
        self.dispatched = len(taken) * self.traffic["batch"]
        return {"detect_images_per_s": len(self.results) / (t1 - t0), "attempted": self.dispatched,
                "window_s": t1 - t0}

    def traced_stretch(self) -> None:
        self.traced = list(range(self.traffic["trace_batches"]))
        self.loop(self.batch(n) for n in self.traced)

    def release_graphs(self) -> None:
        """The loop's captured graphs freed, for the readers' own captures."""
        self.fns["groups"].graphs.clear()
        _free(self.device)

    # what the readers take of the program
    def program(self) -> Dict:
        body = self.fns["groups"].body
        return {"cfg": self.cfg, "model": body.model, "apply_vars": body.select(self.variables),
                "priors": body.priors}

    def check(self) -> Dict[str, float]:
        """The sampled images' detections against the reference's."""
        B, traffic = self.traffic["batch"], self.traffic
        got = {int(r["image_id"]): r for r in self.results}
        missing = sum(1 for i in range(self.dispatched) if i not in got)
        self.fns = self.variables = None  # the program's state, freed
        _free(self.device)
        rng = np.random.default_rng(inputs.sub_seed(self.seed, inputs.SAMPLE))
        ids = sorted(int(i) for i in rng.choice(sorted(got), min(traffic["check_images"],
                                                                 len(got)), replace=False))
        canvases = np.stack([self.pool[(i // B) % len(self.pool)][i % B] for i in ids])
        _reference_precision()
        ref_boxes, ref_logits = ref_detect.boxes_and_logits(
            self.spec, self.params, self.stats, torch.as_tensor(canvases, device=self.device),
            torch.as_tensor(self.priors, device=self.device), block=B)
        cfg = self.cfg
        numbers = check.detect_numbers([got[i] for i in ids], ref_boxes, ref_logits,
                                       cfg.max_detections, cfg.nms_iou_threshold,
                                       cfg.detect_score_threshold)
        numbers["missing"] = float(missing)
        self.failed = missing
        return numbers


class _EagerSteps:
    """The train step where there are no CUDA graphs (the CPU): the groups'
    steps one after another, eagerly."""

    def __init__(self, step_fn):
        self.step_fn = step_fn

    def __call__(self, state, batches):
        metrics = None
        for b in batches:
            state, metrics = self.step_fn(state, b)
        return state, metrics


class TrainCell:
    """The ``train`` kind."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, clock):
        from multibox_tpu_torch.data.pipeline import Prefetcher
        from multibox_tpu_torch.inference import build_model
        from multibox_tpu_torch.train.loop import GraphedTrainStep, make_augmented_train_step
        from multibox_tpu_torch.train.state import create_train_state

        self.Prefetcher = Prefetcher
        self.cell, self.seed, self.device, self.clock = cell, seed, device, clock
        self.traffic = cell.traffic
        self.spec = model_spec(cell.config)
        self.cfg = port_config(cell.config, self.traffic, seed)
        self.priors = inputs.make_priors(self.spec, seed)
        self.params, self.stats = inputs.make_weights(self.spec, seed, device)
        self.pool = inputs.make_train_pool(self.traffic, seed, device)
        self.model = build_model(self.cfg, len(self.priors), device=device)
        self.state = create_train_state(self.cfg, self.model, 0, len(self.priors), device=device,
                                        variables={"params": self.params,
                                                   "batch_stats": self.stats})
        self.step_fn = make_augmented_train_step(self.cfg, self.model, self.priors, device=device)
        self.steps = GraphedTrainStep(self.step_fn) if device.type == "cuda" \
            else _EagerSteps(self.step_fn)
        self.next_batch = 0  # the pool's next batch
        self.fed: List[int] = []  # pool index of each step fed since the last feed began

    def feed(self, batches, group: int, after: Optional[Callable[[Dict], None]] = None):
        """The window's call and feed: a prefetch thread, groups of
        ``group`` steps; ``after(metrics)`` follows each group; returns the
        last group's metrics."""
        pending, metrics = [], None
        for batch in self.Prefetcher(iter(batches), depth=PREFETCH):
            pending.append(batch)
            if len(pending) == group:
                with record_function("bench.train_step"):
                    self.state, metrics = self.steps(self.state, pending)
                if after is not None:
                    after(metrics)
                pending = []
        if pending:
            raise RuntimeError("a feed ended inside a group")
        return metrics

    def _pool_batch(self, n: int) -> Dict:
        index = (self.next_batch + n) % len(self.pool)
        self.fed.append(index)
        return self.pool[index]

    def _take(self, count: int) -> List[Dict]:
        self.fed = []
        out = [self._pool_batch(n) for n in range(count)]
        self.next_batch += count
        return out

    def setup(self) -> None:
        """The first three steps in one feed, as the window feeds them (the
        prefetch thread up to ``PREFETCH`` batches ahead, nothing waiting
        for the device between steps), one a group (the graph captured at
        the first), with what the check reads of them; then a whole group."""
        losses = []

        def after(metrics):
            losses.append(metrics["loss"])
            if len(losses) == 1:
                self.first = {"nu": _clone(self.state.opt_state["nu"])}

        self.feed(self._take(3), 1, after)
        self.first.update(losses=[float(x) for x in losses], params=_clone(self.state.params),
                          ema=_clone(self.state.ema_params),
                          batch_stats=_clone(self.state.batch_stats))
        K = self.traffic["steps_per_host_transfer"]
        if K > 1:
            self.feed(self._take(K), K)
        _sync(self.device)

    def window(self, seconds: float) -> Dict[str, float]:
        K, taken = self.traffic["steps_per_host_transfer"], []
        self.fed = []
        t0 = self.clock()
        self.feed(_until(self.clock, t0 + seconds, K, self._pool_batch, taken), K)
        _sync(self.device)
        t1 = self.clock()
        self.next_batch += len(taken)
        return {"train_images_per_s": self.traffic["batch"] * len(taken) / (t1 - t0),
                "attempted": len(taken), "window_s": t1 - t0}

    def traced_stretch(self) -> None:
        self.traced_from = self.state.step
        self.feed(self._take(self.traffic["trace_steps"]), self.traffic["steps_per_host_transfer"])
        self.traced = list(self.fed)

    def release_graphs(self) -> None:
        """Nothing: the step's graphs leave the readers room enough."""

    def program(self) -> Dict:
        return {"cfg": self.cfg, "model": self.model,
                "apply_vars": {"params": self.state.params, "batch_stats": self.state.batch_stats},
                "priors": self.step_fn.base.priors}

    def check(self) -> Dict[str, float]:
        """The first three steps against the reference's."""
        self.state = self.steps = self.step_fn = self.model = None  # the program's, freed
        _free(self.device)
        _reference_precision()
        tc = {**self.cell.config["train"], "batch_size": self.traffic["batch"],
              "box_encoding": self.spec["box_encoding"]}
        batches = [{k: torch.as_tensor(v, device=self.device) for k, v in self.pool[n].items()}
                   for n in range(3)]
        ref = ref_train.train_steps(self.spec, tc, self.params, self.stats,
                                    torch.as_tensor(self.priors, device=self.device), batches,
                                    self.seed)
        self.failed = 0
        return check.train_numbers(self.first, ref, self.params, self.stats,
                                   self.cfg.rmsprop_decay)


KINDS = {"detect": DetectCell, "train": TrainCell}


def _clone(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tree.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _reference_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Context:
    """What a per-layer reader reads: the cell, the program's parts, the
    traced stretch and the unprofiled window's rate."""

    def __init__(self, cell: Cell, runner, trace: devtrace.Trace, rates: Dict[str, float]):
        self.cell, self.runner, self.trace, self.rates = cell, runner, trace, rates
        self.spec = runner.spec
        self.traffic = cell.traffic
        self.device = runner.device
        self.program = runner.program()
        self.traced = runner.traced  # pool batches (detect) or fed pool indices (train)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, clock: Callable[[], float] = time.perf_counter,
        log: Optional[Callable[[str], None]] = None) -> Dict:
    """One run; the result line's object."""
    say = log or (lambda s: None)
    say(f"set-up: imports {clock() - t_start:.2f} s")
    runner = KINDS[cell.traffic["kind"]](cell, seed, device, clock)
    say(f"set-up: inputs, weights and the program built {clock() - t_start:.2f} s")
    runner.setup()
    setup_s = clock() - t_start
    say(f"set-up: warm-up and captures done {setup_s:.2f} s")
    measured = runner.window(seconds)
    say(f"window: {measured}")
    out_device = {"platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  "count": 1}
    breakdown = None
    if trace:
        tr = devtrace.record(runner.traced_stretch)
        busy, window = devtrace.busy_and_window_s(tr)
        out_device.update(busy_s=busy, window_s=window)
        breakdown = devtrace.breakdown(tr)
    # the program's peak: before the readers' own captures
    out_device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
    if trace:
        ctx = Context(cell, runner, tr, measured)
        runner.release_graphs()
        metrics = {}
        for name in cell.per_layer:
            value = load_reader(cell.root, name)(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": cell.units[name]}
    else:
        values = {"setup_s": setup_s, **measured}
        metrics = {name: {"value": float(values[name]), "unit": cell.units[name]}
                   for name in cell.end_to_end}
    t_check = clock()
    checks = check.judge(runner.check(), cell.limits)
    say(f"check took {clock() - t_check:.1f} s")
    result = {"correct": check.passed(checks), "attempted": int(measured["attempted"]),
              "failed": int(runner.failed), "metrics": metrics, "device": out_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
