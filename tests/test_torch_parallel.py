"""The port's data parallelism on the CPU: two ranks in a gloo group
(``tests/torch_parallel_worker.py``) against the JAX package over the
global batch, and against the port in one process.

The JAX package runs its train step under ``jax.jit`` over a global batch
sharded on its leading axis, so every reduction over the batch in the step
is global; the port's ranks reach the same numbers through explicit
collectives (``multibox_tpu_torch/parallel``). The two ranks are spawned
once for the module and run every case in one process group; each test
checks its part. Every child has a join timeout and the group a finite
timeout, so a hang fails the test.

Sizes are tests/test_torch_train.py's (75 px, 8 priors, a float64
backbone where train steps are compared, for the reasons its docstring
gives), global batches of 2-4 images. Tolerances: BatchNorm in float64
1e-6 (against flax and against one process); the loss and its gradients
in float32 rtol 1e-5 (sums in another order); one train step 1e-5 as in
tests/test_torch_train.py (the RMSProp second moments rtol 1e-3 of the
tensor's largest entry, as there); the detect loop's boxes and scores
1e-5 with counts exact. train() over 4 steps against one process (chunks
of 2 steps, so the losses of steps 2 and 4 are logged): rtol 1e-5 at step
2, one update in (measured 1e-8), 2e-2 at step 4 (measured 3e-3: the
float32 head's sums over 2 rows against 4, amplified by each update, as
tests/test_torch_train.py's docstring describes); the run resumed from its
step-2 checkpoint against the unsegmented one: bitwise (same topology,
same program, the CPU deterministic).
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch
from torch.func import functional_call

from multibox_tpu import inference as jinf
from multibox_tpu.config import Config as JConfig
from multibox_tpu.data.pipeline import DetectionDataset as JDetectionDataset
from multibox_tpu.train.loss import multibox_loss as jloss
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.data.example_proto import build_detection_example
from multibox_tpu_torch.data.tfrecord import TFRecordWriter, read_records
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.models import convert, detector
from multibox_tpu_torch.models.inception_v3 import SlimBatchNorm
from multibox_tpu_torch.parallel import (
    coordination_barrier,
    init_data_parallel,
    process_allgather_objects,
)
from multibox_tpu_torch.train import create_train_state
from multibox_tpu_torch.train.loop import make_augmented_train_step, train
from tests.conftest import random_boxes
from tests.test_torch_detect import spread
from multibox_tpu.models.detector import MultiBoxDetector as JDetector
from multibox_tpu.train import create_train_state as jcreate
from multibox_tpu.train import make_train_step as jmake_step
from tests.test_torch_train import TINY, assert_trees_close, numpy_tree, tiny_world
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_CASES = {
    "one_update": dict(TINY, clip_gradient_norm=1.0),
    "grad_accum2": dict(TINY, clip_gradient_norm=1.0, grad_accum_steps=2),
    "augmented": dict(TINY, clip_gradient_norm=1.0, augment=True, color_distort=True),
    # configs/coco_dp.yaml's loss: 80 classes, Hungarian with dense matching
    "coco_dp": dict(TINY, num_classes=80, matching="hungarian", multi_match_iou=0.5,
                    label_offset=1),
}
# the coco_dp case's labels, after label_offset: classes up to 79
COCO_LABELS = np.array([[79, 0, 41], [12, 79, 5]], np.int32)


def case_world(kw):
    """``tiny_world``'s priors and batch, with labels for a multi-class case."""
    priors, batch = tiny_world()
    if kw.get("num_classes", 1) > 1:
        batch = dict(batch, labels=COCO_LABELS)
    return priors, batch
TRAIN_KW = dict(backbone="mobilenet_v2", mobilenet_width=0.5, input_size=75, num_priors=8,
                batch_size=4, max_num_bboxes=3, compute_dtype="float64",
                steps_per_host_transfer=2, log_every_steps=1, initial_learning_rate=0.003,
                num_train_examples=8, bn_momentum=0.9)
DETECT_KW = dict(input_size=75, num_priors=16, compute_dtype="float32", max_detections=8,
                 detect_score_threshold=0.0, nms_iou_threshold=0.5, batch_size=2)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_records(path, n, canvas, rng):
    with TFRecordWriter(path) as w:
        for i in range(n):
            boxes = random_boxes(rng, int(rng.integers(1, 4)), min_size=0.2)
            img = np.full((canvas, canvas, 3), 30, np.uint8)
            for y0, x0, y1, x1 in (boxes * canvas).astype(int):
                img[y0:y1, x0:x1] = rng.integers(120, 256, 3)
            w.write(build_detection_example(b"", f"im{i}", boxes, labels=[1] * len(boxes),
                                            raw_canvas=img))


def rank_ordered(src, dst, world, local):
    """A copy of the records at ``src`` laid out so that ``world`` ranks,
    each reading ``local`` rows a step from its round-robin shard
    (``DetectionDataset``'s rule, the JAX package's), read in rank order
    the batches one process reads from ``src`` (no shuffling): record
    ``world·(s·local + j) + r`` is ``src``'s ``(s·world + r)·local + j``."""
    recs = list(read_records([src], use_native=False))
    assert len(recs) % (world * local) == 0
    out = [None] * len(recs)
    for i, rec in enumerate(recs):
        s, g = divmod(i, world * local)
        r, j = divmod(g, local)
        out[world * (s * local + j) + r] = rec
    with TFRecordWriter(dst) as w:
        for rec in out:
            w.write(rec)


def run_jax(kw, steps):
    """tests/test_torch_train.py's ``run_jax`` (float64 backbone) where the
    optimizer is a chain with clipping: its RMSProp state is found by its
    ``nu``; a multi-class case's head has its classes and its batch labels."""
    priors, batch = case_world(kw)
    with jax.enable_x64(True):
        cfg = JConfig(**kw)
        model = JDetector(num_priors=8, num_classes=cfg.num_classes, compute_dtype=jnp.float64)
        state = jcreate(cfg, model, jax.random.PRNGKey(0), 8)
        init = numpy_tree({"params": state.params, "batch_stats": state.batch_stats})
        state = state.replace(batch_stats=jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64), state.batch_stats))
        step = jax.jit(jmake_step(cfg, model, jnp.asarray(priors)))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        metrics = []
        for _ in range(steps):
            state, m = step(state, jb)
            metrics.append({k: float(v) for k, v in m.items()})
        nu = next(s.nu for s in jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda x: hasattr(x, "nu")) if hasattr(s, "nu"))
        final = numpy_tree({"params": state.params, "batch_stats": state.batch_stats,
                            "ema": state.ema_params, "nu": nu})
    return init, metrics, final


def make_inputs(root):
    rng = np.random.default_rng(7)
    priors, batch = tiny_world()
    # the step cases: the JAX package's initial variables (float64 backbone)
    init, _, _ = run_jax(STEP_CASES["one_update"], 0)
    coco_init, _, _ = run_jax(STEP_CASES["coco_dp"], 0)
    aug_batch = {"images": rng.integers(0, 256, (2, 86, 86, 3), dtype=np.uint8),
                 "boxes": batch["boxes"], "num_boxes": batch["num_boxes"]}
    gt = np.stack([random_boxes(rng, 3) for _ in range(4)])
    num = np.array([3, 2, 0, 0], np.int32)  # rank 1 holds no positive
    loss_priors = np.sort(rng.uniform(0.05, 0.95, (32, 2, 2)).astype(np.float32),
                          axis=1).reshape(32, 4)
    jcfg = JConfig(**DETECT_KW)
    jvars = jax.tree_util.tree_map(np.asarray, jax.jit(jinf.build_model(jcfg, 16).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3), jnp.float32)))
    jvars = spread(jvars, np.random.default_rng(1))
    train_rec, detect_rec = os.path.join(root, "train.tfrecord"), os.path.join(root, "det.tfrecord")
    write_records(train_rec, 8, 86, rng)
    # what the two ranks read: the one-process batches, augmented alike
    ranks_rec = os.path.join(root, "train_rank_order.tfrecord")
    rank_ordered(train_rec, ranks_rec, 2, TRAIN_KW["batch_size"] // 2)
    write_records(detect_rec, 7, 75, rng)  # shards of 4 and 3, partial last batches
    return {
        "timeout_s": 120,
        "bn": {"x": rng.normal(0.3, 1.0, (4, 6, 5, 5)), "w": rng.normal(0, 1, (4, 6, 5, 5)),
               "scale": rng.uniform(0.5, 1.5, 6), "bias": rng.normal(0, 0.1, 6),
               "mean": rng.normal(0, 0.1, 6), "var": rng.uniform(0.5, 1.5, 6)},
        "loss": {"loc": rng.normal(0, 0.1, (4, 32, 4)).astype(np.float32),
                 "conf": rng.normal(0, 1, (4, 32)).astype(np.float32),
                 "gt": gt, "num": num, "priors": loss_priors},
        "step": {"cases": STEP_CASES, "init": init, "priors": priors, "batch": batch,
                 "aug_batch": aug_batch, "coco_init": coco_init,
                 "coco_batch": case_world(STEP_CASES["coco_dp"])[1]},
        "train": {"kw": TRAIN_KW, "records": train_rec, "rank_records": ranks_rec,
                  "priors": priors,
                  "root": os.path.join(root, "train_2ranks")},
        "detect": {"kw": DETECT_KW, "records": detect_rec, "variables": jvars,
                   "priors": np.sort(rng.uniform(0.05, 0.95, (16, 2, 2)).astype(np.float32),
                                     axis=1).reshape(16, 4)},
    }


def one_process_train(tr, logdir):
    """The port's train() in this process: the logged losses."""
    train(Config(**tr["kw"]), [tr["records"]], tr["priors"], logdir, max_steps=4,
          schedule_total=4, shuffle=False, device="cpu")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once; while they run, the JAX package's steps
    and the port's one-process train() run here. Yields ``(inputs, [rank
    0's results, rank 1's], references)``."""
    root = str(tmp_path_factory.mktemp("torch_parallel"))
    inputs = make_inputs(root)
    inp_path = os.path.join(root, "inputs.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(inputs, f)
    port = free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   MULTIBOX_BARRIER_TIMEOUT_S=str(inputs["timeout_s"]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker", inp_path, root],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        refs = {"jax_steps": {c: run_jax(STEP_CASES[c], 1)
                              for c in ("one_update", "grad_accum2", "coco_dp")},
                "train_losses": one_process_train(inputs["train"], os.path.join(root, "one"))}
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(
        f"rank {r} exited {p.returncode}:\n{err[-3000:]}"
        for r, (p, (_, err)) in enumerate(zip(procs, logs)))
    outs = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    yield inputs, outs, refs


def test_one_process_gather_is_a_passthrough_and_the_barrier_a_no_op():
    obj = {"a": np.arange(3)}
    got = process_allgather_objects(obj)
    assert len(got) == 1 and got[0] is obj
    coordination_barrier("nothing")


def test_init_data_parallel_without_an_environment_does_nothing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_data_parallel() is False
    assert not torch.distributed.is_initialized()


def test_resolve_device_under_a_group_raises_without_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this test describes a machine without a CUDA device")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_data_parallel()  # NCCL by default
    assert init_data_parallel(backend="gloo", timeout_s=30) is True
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        assert resolve_device("cpu") == torch.device("cpu")
    finally:
        torch.distributed.destroy_process_group()


def test_two_ranks_gather_in_rank_order_refuse_large_objects_and_meet(ranks):
    _, outs, refs = ranks
    want = [{"rank": 0, "items": list(range(10))}, "x" * 1000]
    for out in outs:
        assert out["world"] == 2
        assert out["gather"]["gathered"] == want
        assert "too large for one cross-process gather" in out["gather"]["refusal"]
    assert [o["rank"] for o in outs] == [0, 1]


def test_batch_norm_takes_the_global_batch_statistics(ranks):
    """Train-mode SlimBatchNorm with γ over 2 + 2 images: output, input
    gradient, γ and β gradients (summed over the ranks, as the step's
    all-reduce does) and the running statistics, against one process over
    the 4 images and against flax's BatchNorm, float64, 1e-6."""
    inputs, outs, refs = ranks
    bn = inputs["bn"]
    m = SlimBatchNorm(6, momentum=0.9, use_scale=True)
    x = torch.from_numpy(bn["x"]).requires_grad_(True)
    params = {"scale": torch.from_numpy(bn["scale"]).requires_grad_(True),
              "bias": torch.from_numpy(bn["bias"]).requires_grad_(True),
              "mean": torch.from_numpy(bn["mean"]), "var": torch.from_numpy(bn["var"])}
    y = functional_call(m, params, (x, True))
    gx, gs, gb = torch.autograd.grad((y * torch.from_numpy(bn["w"])).sum(),
                                     [x, params["scale"], params["bias"]])
    got = {k: np.concatenate([o["batch_norm"][k] for o in outs]) for k in ("y", "gx")}
    np.testing.assert_allclose(got["y"], y.detach().numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got["gx"], gx.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(sum(o["batch_norm"]["gscale"] for o in outs), gs.numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(sum(o["batch_norm"]["gbias"] for o in outs), gb.numpy(),
                               atol=1e-6, rtol=1e-6)
    for o in outs:
        np.testing.assert_allclose(o["batch_norm"]["mean"], m.updated[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(o["batch_norm"]["var"], m.updated[1].numpy(), atol=1e-6)
    with jax.enable_x64(True):
        fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3,
                            dtype=jnp.float64, param_dtype=jnp.float64)
        xh = jnp.asarray(bn["x"].transpose(0, 2, 3, 1))
        fy, upd = fbn.apply({"params": {"scale": bn["scale"], "bias": bn["bias"]},
                             "batch_stats": {"mean": bn["mean"], "var": bn["var"]}},
                            xh, mutable=["batch_stats"])
        np.testing.assert_allclose(got["y"], np.asarray(fy).transpose(0, 3, 1, 2), atol=1e-6)
        np.testing.assert_allclose(outs[0]["batch_norm"]["var"],
                                   np.asarray(upd["batch_stats"]["var"]), atol=1e-6)


def test_loss_normalises_by_the_global_batch_with_a_rank_without_positives(ranks):
    """multibox_loss over 2 + 2 rows, rank 1's without a gt box: the
    metrics are the global batch's and each rank's gradients its rows of
    the JAX package's over the 4 rows (float32, rtol 1e-5)."""
    inputs, outs, refs = ranks
    ls = inputs["loss"]

    def f(loc, conf):
        return jloss(loc, conf, jnp.asarray(ls["gt"]), jnp.asarray(ls["num"]),
                     jnp.asarray(ls["priors"]))

    (total, metrics), (gl, gc) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(ls["loc"]), jnp.asarray(ls["conf"]))
    assert outs[1]["loss"]["metrics"]["num_pos"] == float(metrics["num_pos"]) > 0
    np.testing.assert_allclose(sum(o["loss"]["local_loss"] for o in outs), float(total),
                               rtol=1e-5)
    for o in outs:
        assert set(o["loss"]["metrics"]) == set(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(o["loss"]["metrics"][k], float(v), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    np.testing.assert_allclose(np.concatenate([o["loss"]["gloc"] for o in outs]),
                               np.asarray(gl), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(np.concatenate([o["loss"]["gconf"] for o in outs]),
                               np.asarray(gc), rtol=1e-5, atol=1e-8)
    assert not np.any(outs[1]["loss"]["gloc"])  # no positive: no location gradient


def torch_state(s):
    """A worker's numpy state as the trees ``assert_trees_close`` reads."""
    class State:
        params = {k: torch.from_numpy(v) for k, v in s["params"].items()}
        batch_stats = {k: torch.from_numpy(v) for k, v in s["batch_stats"].items()}
        ema_params = {k: torch.from_numpy(v) for k, v in s["ema"].items()}
        opt_state = {"nu": {k: torch.from_numpy(v) for k, v in s["nu"].items()}}
    return State


@pytest.mark.parametrize("case", ["one_update", "grad_accum2", "coco_dp"])
def test_train_step_over_two_ranks_matches_one_jax_step_over_the_global_batch(ranks, case):
    """One RMSProp update with clipping and EMA, the JAX package's step over
    the 2-image batch against each rank's step on its image (rank 1 starts
    from other parameters: replicate_state broadcasts rank 0's).
    ``grad_accum2``: microbatch 0 is rank 0's image and microbatch 1 rank
    1's, so each rank runs one microbatch with zero rows. ``coco_dp``:
    configs/coco_dp.yaml's loss (80 classes, Hungarian matching with dense
    matching at 0.5; each rank matches its own image, the positives are
    summed over both). The replicas come out bitwise equal."""
    _, outs, refs = ranks
    _, jmetrics, final = refs["jax_steps"][case]
    for o in outs:
        got = o["steps"][case]
        assert got["state"]["step"] == 1 and got["state"]["count"] == 1
        for k, v in jmetrics[0].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        assert_trees_close(final, torch_state(got["state"]), atol=1e-5, with_nu=True)
    assert outs[0]["steps"][case]["digest"] == outs[1]["steps"][case]["digest"]
    a, b = (o["steps"][case]["collectives"] for o in outs)
    assert a == b and a["gradients"] == 1 and a["broadcast"] == 2
    micro = STEP_CASES[case].get("grad_accum_steps", 1)
    assert a["loss"] == 2 * micro and a["batch_norm"] == 2 * 94 * micro


def test_augmented_step_draws_for_the_global_batch(ranks):
    """With augmentation on, each rank's step on its canvas against the port
    in one process over both: the parameters are drawn for the global batch
    and each rank keeps its rows, so every image is augmented alike."""
    inputs, outs, refs = ranks
    st = inputs["step"]
    kw = STEP_CASES["augmented"]
    cfg = Config(**kw)
    model = detector.MultiBoxDetector(num_priors=8, input_size=75, compute_dtype=torch.float64,
                                      device="cpu")
    state = create_train_state(cfg, model, 0, 8, device="cpu",
                               variables=convert.flax_to_torch(st["init"], device="cpu"))
    step = make_augmented_train_step(cfg, model, st["priors"], device="cpu")
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in st["aug_batch"].items()})
    for o in outs:
        got = o["steps"]["augmented"]
        for k, v in metrics.items():
            np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        for coll, tree in (("params", state.params), ("batch_stats", state.batch_stats),
                           ("ema", state.ema_params)):
            for k, v in tree.items():
                np.testing.assert_allclose(got["state"][coll][k], v.detach().numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=f"{coll}/{k}")
    assert outs[0]["steps"]["augmented"]["digest"] == outs[1]["steps"]["augmented"]["digest"]


def test_train_from_records_over_two_ranks(ranks):
    """train() from 8 records at a global batch of 4 (2 a rank, chunks of 2
    steps), 4 steps, augmentation on, MobileNetV2 0.5 at 75 px with a
    float64 backbone: the losses against the port's one-process run (the
    ranks read a copy of its records in rank order, so that their global
    batches are its batches and each image is augmented alike); the
    run stopped at step 2 and resumed to 4 equal to the unsegmented one;
    metrics.jsonl written once a step, by rank 0; the replicas equal."""
    _, outs, refs = ranks
    want = refs["train_losses"]
    files = {"unsegmented": ["ckpt_4.pt"], "segmented": ["ckpt_2.pt", "ckpt_4.pt"]}
    for name, run in ((n, [o["train"][n] for o in outs]) for n in files):
        # a chunk of 2 steps a call: its last step's metrics are logged
        assert [r["step"] for r in run[0]["logged"]] == [2, 4]
        assert run[1]["logged"] is None  # rank 1 read nothing: see the worker
        assert run[0]["step"] == run[1]["step"] == 4
        assert run[0]["digest"] == run[1]["digest"]
        assert [f for f in run[0]["files"] if f.startswith("ckpt_")] == files[name]
        assert "metrics.jsonl" in run[0]["files"]
    got = [r["loss"] for r in outs[0]["train"]["unsegmented"]["logged"]]
    assert len(want) == 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)  # after one update
    np.testing.assert_allclose(got[1], want[1], rtol=2e-2)  # after three: chaotic
    assert outs[0]["train"]["segmented"]["digest"] == outs[0]["train"]["unsegmented"]["digest"]


def test_checkpoint_saves_decide_alike_on_every_rank(ranks):
    """A save every step with rank 1 arriving late, at making its manager
    and at each save: rank 0 has written the step's file by then, and rank
    1 still decides to save (the managers are made between two barriers,
    and the decision comes from the manager's own record, not the
    directory), so neither waits for the other at the save's barrier."""
    _, outs, _ = ranks
    for o in outs:
        assert o["checkpoint"]["saved"] == [True, True, True]
        assert o["checkpoint"]["steps"] == [2, 3] and o["checkpoint"]["latest"] == 3


def test_sharded_detect_loop_gathers_the_jax_one_process_results(ranks):
    """run_detect_loop over 7 records sharded 4 / 3 (batches of 2, partial
    last batches) on each rank, gathered, against the JAX package's
    run_detect_loop in one process on the same weights: the same image
    ids, counts exact, boxes and scores 1e-5. Both ranks on shard 0 raise
    the duplicate-id error; a dataset not sharded over the ranks raises."""
    inputs, outs, refs = ranks
    de = inputs["detect"]
    jcfg = JConfig(**DETECT_KW)
    want = jinf.run_detect_loop(
        jcfg, jax.tree_util.tree_map(jnp.asarray, de["variables"]),
        JDetectionDataset([de["records"]], batch_size=2, canvas_size=75, max_num_bboxes=4),
        jnp.asarray(de["priors"]))
    want = {r["image_id"]: r for r in want}
    for o in outs:
        got = o["detect"]["results"]
        assert [r["image_id"] for r in got] == \
            [f"im{i}" for i in (0, 2, 4, 6, 1, 3, 5)]  # rank 0's shard, then rank 1's
        for g in got:
            w = want[g["image_id"]]
            assert len(g["scores"]) == len(w["scores"]) > 0
            np.testing.assert_array_equal(g["classes"], np.asarray(w["classes"]))
            np.testing.assert_allclose(g["scores"], np.asarray(w["scores"]), atol=1e-5)
            np.testing.assert_allclose(g["boxes"], np.asarray(w["boxes"]), atol=1e-5)
        assert "duplicate image ids" in o["detect"]["duplicate"]
        assert o["detect"]["unsharded"].startswith("ValueError: multi-process detect needs")


def test_two_processes_build_the_native_reader_once(tmp_path):
    """Two processes (two ranks starting together) load the native reader
    from an empty build directory at once: one compiles under the build
    lock, the other waits and loads the same library."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native reader cannot be built here")
    build, log = tmp_path / "build", tmp_path / "compiles.log"
    code = ("from multibox_tpu_torch.data import _native\n"
            f"_native._BUILD_DIR = {str(build)!r}\n"
            "find = _native.find_cxx\n"
            "def logged():\n"
            f"    open({str(log)!r}, 'a').write('compile\\n')\n"
            "    return find()\n"
            "_native.find_cxx = logged\n"
            "lib = _native.reader_library()\n"
            "print(_native.build('tfrecord_reader'), lib.mbx_crc32c(b'123456789', 9))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.split()[0] for o, _ in outs}
    assert len(paths) == 1 and {o.split()[1] for o, _ in outs} == {str(0xE3069283)}
    assert log.read_text() == "compile\n"
    assert os.listdir(build) == [os.path.basename(paths.pop())]
