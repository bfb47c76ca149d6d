"""One rank of tests/test_torch_parallel.py's 2-rank gloo group on the CPU.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python -m tests.torch_parallel_worker INPUTS.pkl OUT_DIR

Reads the cases' inputs (numpy, made by the test from a seed), runs every
2-rank case in one process group and writes ``OUT_DIR/rank<r>.pkl``: per
case, what the test compares (numpy). Imports the port only: the JAX
package's side of each comparison runs in the test process.
"""

import hashlib
import json
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
from torch.func import functional_call

torch.set_num_threads(1)

from multibox_tpu_torch.config import Config  # noqa: E402
from multibox_tpu_torch.data.pipeline import DetectionDataset  # noqa: E402
from multibox_tpu_torch.inference import build_model, run_detect_loop  # noqa: E402
from multibox_tpu_torch.models import convert, detector  # noqa: E402
from multibox_tpu_torch.models.inception_v3 import SlimBatchNorm  # noqa: E402
from multibox_tpu_torch.parallel import (  # noqa: E402
    coordination_barrier,
    gather,
    init_data_parallel,
    make_parallel_train_step,
    mesh,
    process_allgather_objects,
    replicate_state,
)
from multibox_tpu_torch.train import create_train_state, make_train_step  # noqa: E402
from multibox_tpu_torch.train.loop import make_augmented_train_step, train  # noqa: E402
from multibox_tpu_torch.train.loss import multibox_loss  # noqa: E402

RANK = int(os.environ["RANK"])


def rows(a, n):
    """This rank's ``n`` rows of a global array."""
    return a[RANK * n:(RANK + 1) * n]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def state_numpy(state):
    return {"step": state.step,
            **{coll: {k: v.detach().numpy().copy() for k, v in tree.items()}
               for coll, tree in (("params", state.params), ("batch_stats", state.batch_stats),
                                  ("ema", state.ema_params),
                                  ("nu", state.opt_state.get("nu", {})))},
            "count": state.opt_state["count"]}


def state_digest(state):
    h = hashlib.sha256()
    for coll in ("params", "batch_stats", "ema_params"):
        for k, v in getattr(state, coll).items():
            h.update(k.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    for name, tree in state.opt_state.items():
        if isinstance(tree, dict):
            for k, v in tree.items():
                h.update(v.contiguous().numpy().tobytes())
        else:
            h.update(str(tree).encode())
    return h.hexdigest()


def case_gather(inp):
    objs = [{"rank": 0, "items": list(range(10))}, "x" * 1000]
    got = process_allgather_objects(objs[RANK])
    t0 = time.perf_counter()
    coordination_barrier("test")
    waited = time.perf_counter() - t0
    gather.MAX_BYTES = 100
    try:
        process_allgather_objects("y" * 200)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    finally:
        gather.MAX_BYTES = 2**31
    return {"gathered": got, "refusal": refusal, "barrier_s": waited}


def case_batch_norm(inp):
    bn = inp["bn"]
    n = bn["x"].shape[0] // 2
    m = SlimBatchNorm(bn["x"].shape[1], momentum=0.9, use_scale=True)
    x = t(rows(bn["x"], n)).requires_grad_(True)
    params = {"scale": t(bn["scale"]).requires_grad_(True), "bias": t(bn["bias"]).requires_grad_(True),
              "mean": t(bn["mean"]), "var": t(bn["var"])}
    with mesh.data_parallel():
        y = functional_call(m, params, (x, True))
    gx, gs, gb = torch.autograd.grad((y * t(rows(bn["w"], n))).sum(),
                                     [x, params["scale"], params["bias"]])
    return {"y": y.detach().numpy(), "gx": gx.numpy(), "gscale": gs.numpy(),
            "gbias": gb.numpy(), "mean": m.updated[0].numpy(), "var": m.updated[1].numpy()}


def case_loss(inp):
    ls = inp["loss"]
    n = ls["loc"].shape[0] // 2
    loc = t(rows(ls["loc"], n)).requires_grad_(True)
    conf = t(rows(ls["conf"], n)).requires_grad_(True)
    with mesh.data_parallel():
        total, metrics = multibox_loss(loc, conf, t(rows(ls["gt"], n)), t(rows(ls["num"], n)),
                                       t(ls["priors"]))
    gl, gc = torch.autograd.grad(total, [loc, conf])
    return {"local_loss": float(total), "metrics": {k: float(v) for k, v in metrics.items()},
            "gloc": gl.numpy(), "gconf": gc.numpy()}


def tiny_state(kw, variables, perturb):
    cfg = Config(**kw)
    model = detector.MultiBoxDetector(num_priors=8, input_size=75, num_classes=cfg.num_classes,
                                      compute_dtype=torch.float64, device="cpu")
    state = create_train_state(cfg, model, 0, 8, device="cpu",
                               variables=convert.flax_to_torch(variables, device="cpu"))
    if perturb:  # rank 1 starts elsewhere: replicate_state must undo it
        with torch.no_grad():
            for v in state.params.values():
                v.add_(1.0)
        state.step = 5
    return cfg, model, replicate_state(state)


def case_steps(inp):
    out = {}
    st = inp["step"]
    for name, kw in st["cases"].items():
        mesh.reset_collective_counts()
        coco = kw.get("num_classes", 1) > 1
        cfg, model, state = tiny_state(kw, st["coco_init"] if coco else st["init"],
                                       perturb=RANK == 1)
        batch = st["aug_batch"] if kw.get("augment") else st["coco_batch"] if coco else \
            st["batch"]
        n = batch["images"].shape[0] // 2
        local = {k: t(rows(v, n)) for k, v in batch.items()}
        if kw.get("augment"):
            step = make_augmented_train_step(cfg, model, st["priors"], device="cpu")
        else:
            step = make_train_step(cfg, model, st["priors"], device="cpu")
        state, metrics = make_parallel_train_step(step)(state, local)
        out[name] = {"state": state_numpy(state), "digest": state_digest(state),
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "collectives": dict(mesh.COLLECTIVES)}
    return out


def case_train(inp):
    tr = inp["train"]
    cfg = Config(**tr["kw"])
    out = {}
    for name, segments in (("unsegmented", [4]), ("segmented", [2, 4])):
        t0 = time.perf_counter()
        logdir = os.path.join(tr["root"], name)
        for steps in segments:
            state = train(cfg, [tr["rank_records"]], tr["priors"], logdir, max_steps=steps,
                          schedule_total=4, shuffle=False, device="cpu")
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f] if RANK == 0 else None
        out[name] = {"digest": state_digest(state), "step": state.step, "logged": logged,
                     "files": sorted(os.listdir(logdir)), "seconds": time.perf_counter() - t0}
    return out


def case_checkpoint(inp):
    """Saves every step with rank 1 late at each and at making its manager:
    both ranks decide alike and come out of each save with the file in
    place."""
    from multibox_tpu_torch.utils.checkpoint import CheckpointManager

    # made between two barriers, as train_from_batches makes its manager: no
    # rank writes the directory while another reads it, however late
    coordination_barrier("checkpoint_case")
    if RANK == 1:
        time.sleep(0.3)
    ckpt = CheckpointManager(os.path.join(inp["train"]["root"], "cadence"), keep=2,
                             save_every=1)
    coordination_barrier("checkpoint_case/made")
    saved = []
    for step in (1, 2, 3):
        if RANK == 1:
            time.sleep(0.3)
        saved.append(ckpt.save(step, {"step": step, "params": {"w": torch.full((3,), step)}}))
    # the directory is read after the last save's barrier, as the train loop does
    return {"saved": saved, "steps": ckpt.all_steps(), "latest": ckpt.latest_step()}


def case_detect(inp):
    de = inp["detect"]
    cfg = Config(**de["kw"])
    variables = convert.flax_to_torch(de["variables"], device="cpu")

    def dataset(index, count=2):
        return DetectionDataset([de["records"]], batch_size=2, canvas_size=75,
                                max_num_bboxes=4, shard_index=index, shard_count=count)

    out = {"results": run_detect_loop(cfg, variables, dataset(RANK), de["priors"],
                                      device="cpu")}
    for name, ds in (("duplicate", dataset(0)), ("unsharded", dataset(0, 1))):
        try:
            run_detect_loop(cfg, variables, ds, de["priors"], device="cpu")
            out[name] = None
        except (RuntimeError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


CASES = (("gather", case_gather), ("batch_norm", case_batch_norm), ("loss", case_loss),
         ("steps", case_steps), ("train", case_train), ("checkpoint", case_checkpoint),
         ("detect", case_detect))


def main():
    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    init_data_parallel(backend="gloo", timeout_s=inp["timeout_s"])
    out = {"world": mesh.world_size(), "rank": mesh.rank()}
    for name, fn in CASES:
        t0 = time.perf_counter()
        try:
            out[name] = fn(inp)
            out[f"{name}_seconds"] = time.perf_counter() - t0
        except Exception:
            out[name] = {"error": traceback.format_exc()}
            raise
        finally:
            with open(os.path.join(sys.argv[2], f"rank{RANK}.pkl"), "wb") as f:
                pickle.dump(out, f)


if __name__ == "__main__":
    main()
