"""``steps_per_host_transfer`` and the pieces of the CUDA-graph steps
(``multibox_tpu_torch.graphs``), on the CPU, where every step is eager.

- The detect loop at K = 1 and 3 against the JAX package's at the same K:
  the golden test's size (Inception-v3 at 75 px, 16 priors), 7 batches, so
  that the last group and the last batch are partial. Same image ids,
  counts exact, boxes and scores within 1e-5 (the golden test's).
- ``train_from_batches`` at K = 3 against K = 1: the same state after 7
  steps, bit for bit. Against the JAX package's chunked loop at learning
  rate 0 (the case its own config pins bit for bit; MobileNetV2 0.5 at 64
  px, float32, augmentation off, from the same initial variables):
  parameters, BatchNorm statistics and EMA within 1e-5 (atol and rtol, as
  the port's step against the JAX package's).
- ``Optimizer.apply`` and ``ema_update`` with the staged 0-d tensors,
  bit for bit against the host-float formulas they replaced, over 20 steps
  that cross a schedule boundary, clipping off and on, on both sides of
  the clip.
- On the card (``-m cuda``; skipped here): one detect loop and one train
  loop captured as graphs, bit for bit against the eager path; the spans
  of graphed groups and the captures counted by owner.

JAX is imported inside the tests that use it, so that the card's run
(``python3 -m pytest -q -m cuda --noconftest tests/test_torch_graphs.py``)
collects this file on a machine without JAX.
"""

import os

import numpy as np
import pytest
import torch

from multibox_tpu_torch import inference as tinf
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.train import state as tstate
from multibox_tpu_torch.train.loop import train_from_batches
from multibox_tpu_torch.utils.checkpoint import CheckpointManager
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def boxes_of(rng, B, G):
    lo = rng.uniform(0.0, 0.6, (B, G, 2))
    size = rng.uniform(0.1, 0.4, (B, G, 2))
    return np.concatenate([lo, np.minimum(lo + size, 1.0)], -1).astype(np.float32)


def detect_batches(rng, batches=7, batch=2, valid_last=1, canvas=90):
    return [{"images": rng.integers(0, 256, (batch, canvas, canvas, 3), dtype=np.uint8),
             "image_ids": [f"im{i}_{j}" if j < (valid_last if i == batches - 1 else batch)
                           else "" for j in range(batch)],
             "batch_valid": np.int32(valid_last if i == batches - 1 else batch)}
            for i in range(batches)]


def train_batches(rng, n, batch=2, G=3, canvas=72):
    out = []
    for _ in range(n):
        num = rng.integers(1, G + 1, batch).astype(np.int32)
        boxes = boxes_of(rng, batch, G)
        boxes[np.arange(G)[None, :] >= num[:, None]] = 0.0
        out.append({"images": rng.integers(0, 256, (batch, canvas, canvas, 3), dtype=np.uint8),
                    "boxes": boxes, "num_boxes": num})
    return out


def state_tensors(state):
    out = {}
    for coll in ("params", "batch_stats", "ema_params"):
        for k, v in getattr(state, coll).items():
            out[f"{coll}/{k}"] = v
    for name, tree in state.opt_state.items():
        if isinstance(tree, dict):
            for k, v in tree.items():
                out[f"opt_state/{name}/{k}"] = v
    return out


def assert_bitwise(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
    assert set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def remove_checkpoints(*dirs):
    for d in dirs:
        for name in os.listdir(d) if os.path.isdir(d) else []:
            if name.endswith(".pt"):
                os.remove(os.path.join(d, name))


# ------------------------------------------------------------------ detect

DETECT = dict(input_size=75, num_priors=16, compute_dtype="float32", max_detections=8,
              detect_score_threshold=0.0, nms_iou_threshold=0.5, batch_size=2)


@pytest.fixture(scope="module")
def detect_world():
    """The golden test's priors and ``model.init(PRNGKey(0))`` variables,
    the confidence biases spread (see tests/test_torch_detect.py)."""
    import jax
    import jax.numpy as jnp

    from multibox_tpu import inference as jinf
    from multibox_tpu.config import Config as JConfig
    from multibox_tpu_torch.models import convert

    rng = np.random.default_rng(42)
    priors = np.sort(rng.uniform(0.05, 0.95, (16, 2, 2)).astype(np.float32),
                     axis=1).reshape(16, 4)
    x = rng.uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    jvars = jax.tree_util.tree_map(np.array, jax.device_get(dict(
        jinf.build_model(JConfig(**DETECT), 16).init(jax.random.PRNGKey(0), jnp.asarray(x)))))
    spread = np.random.default_rng(1)
    head = jvars["params"]["MultiBoxHead"]
    head["Confidences"]["bias"] = spread.normal(0, 1.0, head["Confidences"]["bias"].shape
                                                ).astype(np.float32)
    head["Locations"]["bias"] = spread.normal(0, 0.05, head["Locations"]["bias"].shape
                                              ).astype(np.float32)
    return {"priors": priors, "jvars": jvars,
            "tvars": convert.flax_to_torch(jvars, device="cpu")}


@pytest.mark.parametrize("chunk", [1, 3], ids=["K1", "K3"])
def test_detect_loop_groups_match_jax(detect_world, chunk):
    """7 batches of 2 (the last with one image); at K = 3 two full groups
    and one batch alone, as in the JAX package's loop."""
    import jax.numpy as jnp

    from multibox_tpu import inference as jinf
    from multibox_tpu.config import Config as JConfig

    kw = dict(DETECT, steps_per_host_transfer=chunk)
    data = detect_batches(np.random.default_rng(12))
    want = jinf.run_detect_loop(JConfig(**kw), _as_jax(detect_world["jvars"]), iter(data),
                                jnp.asarray(detect_world["priors"]))
    fns = tinf.make_detect_loop_fns(Config(**kw), detect_world["priors"], device="cpu")
    assert fns["chunk"] == chunk
    got = tinf.run_detect_loop(Config(**kw), detect_world["tvars"], iter(data),
                               detect_world["priors"], fns=fns)
    assert [r["image_id"] for r in got] == [r["image_id"] for r in want]
    assert len(got) == 13 and any(len(r["scores"]) for r in got)
    for g, w in zip(got, want):
        assert len(g["scores"]) == len(w["scores"]), g["image_id"]
        np.testing.assert_array_equal(g["classes"], np.asarray(w["classes"]))
        np.testing.assert_allclose(g["scores"], np.asarray(w["scores"]), atol=1e-5)
        np.testing.assert_allclose(g["boxes"], np.asarray(w["boxes"]), atol=1e-5)


def _as_jax(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(jnp.asarray, tree)


# ------------------------------------------------------------------- train

def small_cfg(**kw):
    base = dict(input_size=75, num_priors=8, batch_size=2, max_num_bboxes=3,
                compute_dtype="float32", initial_learning_rate=0.003,
                num_train_examples=2, log_every_steps=1, save_every_steps=100,
                keep_checkpoints=1)
    base.update(kw)
    return Config(**base)


PRIORS = np.sort(np.random.default_rng(3).uniform(0.05, 0.95, (8, 2, 2)).astype(np.float32),
                 axis=1).reshape(8, 4)


def test_train_groups_of_three_equal_single_steps(tmp_path):
    """7 steps with augmentation and RMSProp at K = 3 (two groups, then a
    step alone) and at K = 1, from the seed's initial state."""
    data = train_batches(np.random.default_rng(5), 7)
    stream = lambda start: iter(data[start:])  # noqa: E731
    try:
        three = train_from_batches(small_cfg(steps_per_host_transfer=3), stream, PRIORS,
                                   str(tmp_path / "k3"), max_steps=7, device="cpu")
        one = train_from_batches(small_cfg(), stream, PRIORS, str(tmp_path / "k1"),
                                 max_steps=7, device="cpu")
    finally:
        remove_checkpoints(str(tmp_path / "k3"), str(tmp_path / "k1"))
    assert three.step == 7
    assert_bitwise(three, one)


MOBILE = dict(input_size=64, num_priors=8, batch_size=2, max_num_bboxes=3,
              compute_dtype="float32", initial_learning_rate=0.0, num_train_examples=2,
              hard_negative_ratio=3.0, backbone="mobilenet_v2", mobilenet_width=0.5,
              bottleneck_features=8, augment=False, steps_per_host_transfer=3)


def test_train_groups_match_jax_chunked_loop_at_lr0(tmp_path):
    """The JAX package's chunked step (``lax.scan`` over 3 steps) twice,
    then one single step, against ``train_from_batches`` at K = 3 resumed
    from the same initial variables (a checkpoint at step 0)."""
    import jax
    import jax.numpy as jnp

    from multibox_tpu.config import Config as JConfig
    from multibox_tpu.models.detector import MultiBoxDetector as JDetector
    from multibox_tpu.train import create_train_state as jcreate
    from multibox_tpu.train.loop import make_augmented_train_step as jaug_step
    from multibox_tpu.train.loop import make_chunked_step as jchunked
    from multibox_tpu_torch.models import convert

    data = train_batches(np.random.default_rng(6), 7)
    jcfg = JConfig(**MOBILE)
    jm = JDetector(num_priors=8, backbone="mobilenet_v2", mobilenet_width=0.5,
                   compute_dtype=jnp.float32, bottleneck_features=8)
    jst = jcreate(jcfg, jm, jax.random.PRNGKey(0), 8)
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(
        {"params": jst.params, "batch_stats": jst.batch_stats}))
    step = jaug_step(jcfg, jm, jnp.asarray(PRIORS))
    chunk = jax.jit(jchunked(step, 3))
    single = jax.jit(step)
    for g in range(2):
        group = data[3 * g:3 * g + 3]
        jst, _ = chunk(jst, {k: jnp.asarray(np.stack([b[k] for b in group]))
                             for k in group[0]})
    jst, _ = single(jst, {k: jnp.asarray(v) for k, v in data[6].items()})
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, jax.device_get(
        {"params": jst.params, "batch_stats": jst.batch_stats, "ema": jst.ema_params})),
        device="cpu")

    cfg = Config(**MOBILE)
    model = tinf.build_model(cfg, 8, device="cpu")
    start = tstate.create_train_state(cfg, model, 0, 8, device="cpu",
                                      variables=convert.flax_to_torch(init, device="cpu"))
    logdir = str(tmp_path / "run")
    try:
        CheckpointManager(logdir).save(0, start, force=True)
        got = train_from_batches(cfg, lambda s: iter(data[s:]), PRIORS, logdir,
                                 max_steps=7, device="cpu")
    finally:
        remove_checkpoints(logdir)
    assert got.step == 7 and got.opt_state["count"] == 7
    have = {"params": got.params, "batch_stats": got.batch_stats, "ema": got.ema_params}
    moved = 0
    for coll, tensors in want.items():
        assert set(have[coll]) == set(tensors), coll
        for k, v in tensors.items():
            np.testing.assert_allclose(have[coll][k].detach().numpy(), v.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=f"{coll}/{k}")
            if coll == "batch_stats":
                moved += not torch.equal(v, convert.flax_to_torch(
                    init, device="cpu")["batch_stats"][k])
    assert moved > 0  # the statistics advanced: the steps ran


# ------------------------------------------------ staged values, bitwise

def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def host_float_apply(opt, params, grads, state):
    """``Optimizer.apply`` as it was with the step's values as host floats
    (and the clip's choice made on the host)."""
    keys = list(params)
    p = [params[k] for k in keys]
    g = [grads[k] for k in keys]
    if opt.clip > 0:
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        if not bool(norm < opt.clip):
            g = [(x / norm) * opt.clip for x in g]
    lr = opt.schedule(state["count"])
    neg_lr = float(_f32(-lr))
    count = state["count"] + 1
    if opt.name == "rmsprop":
        nu = [state["nu"][k] for k in keys]
        torch._foreach_mul_(nu, opt.decay)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - opt.decay))
        u = torch._foreach_mul(torch._foreach_rsqrt(torch._foreach_add(nu, opt.eps)), g)
        torch._foreach_mul_(u, neg_lr)
        trace = [state["trace"][k] for k in keys]
        torch._foreach_mul_(trace, opt.momentum)
        torch._foreach_add_(trace, u)
        u = trace
    elif opt.name == "momentum":
        trace = [state["trace"][k] for k in keys]
        torch._foreach_mul_(trace, opt.momentum)
        torch._foreach_add_(trace, g)
        u = torch._foreach_mul(trace, neg_lr)
    elif opt.name == "sgd":
        u = torch._foreach_mul(g, neg_lr)
    else:
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        torch._foreach_mul_(mu, 0.9)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - 0.9))
        torch._foreach_mul_(nu, 0.999)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - 0.999))
        c1 = float(1 - torch.pow(_f32(0.9), _f32(count)))
        c2 = float(1 - torch.pow(_f32(0.999), _f32(count)))
        den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(den, opt.adam_eps)
        u = torch._foreach_div(torch._foreach_div(mu, c1), den)
        torch._foreach_mul_(u, neg_lr)
    torch._foreach_add_(p, u)
    state["count"] = count


def host_float_ema(ema, params, step, decay):
    t = _f32(step)
    d = float(torch.minimum(_f32(decay), (1.0 + t) / (10.0 + t)))
    keys = list(params)
    shadows = [ema[k] for k in keys]
    torch._foreach_mul_(shadows, d)
    torch._foreach_add_(shadows, torch._foreach_mul([params[k] for k in keys],
                                                    float(1 - _f32(d))))


@pytest.mark.parametrize("clip", [0.0, 2.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", ["rmsprop", "momentum", "sgd", "adam"])
def test_staged_values_update_as_the_host_floats_did(name, clip):
    """20 steps across the staircase's boundaries (every 4 steps) and the
    end of a 3-step warmup; gradients scaled so that their norm falls below
    the clip on some steps and above it on others."""
    cfg = Config(optimizer=name, initial_learning_rate=0.1, num_train_examples=32,
                 batch_size=8, num_epochs_per_decay=1.0, learning_rate_decay_factor=0.5,
                 warmup_steps=3, clip_gradient_norm=clip, rmsprop_epsilon=1.0,
                 moving_average_decay=0.999)
    opt = tstate.make_optimizer(cfg)
    rng = np.random.default_rng(4)
    p0 = {"a": rng.normal(0, 1, (5, 3)).astype(np.float32),
          "b": rng.normal(0, 1, 7).astype(np.float32)}
    got = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    want = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    got_state, want_state = opt.init(got), opt.init(want)
    got_ema = {k: v.clone() for k, v in got.items()}
    want_ema = {k: v.clone() for k, v in want.items()}
    norms = []
    for step in range(20):
        scale = 0.05 if step % 3 == 0 else 3.0
        g = {k: torch.from_numpy(rng.normal(0, scale, v.shape).astype(np.float32))
             for k, v in p0.items()}
        norms.append(float(torch.sqrt(sum(torch.sum(x * x) for x in g.values()))))
        values = opt.scalars(got_state["count"]) + tstate.ema_scalars(step, cfg.moving_average_decay)
        staged = tstate.stage_scalars(values, "cpu")
        opt.apply(got, g, got_state, staged)
        tstate.ema_update(got_ema, got, step, cfg.moving_average_decay, staged[3:])
        host_float_apply(opt, want, g, want_state)
        host_float_ema(want_ema, want, step, cfg.moving_average_decay)
        assert got_state["count"] == want_state["count"] == step + 1
        for k in p0:
            assert torch.equal(got[k], want[k]), (step, k)
            assert torch.equal(got_ema[k], want_ema[k]), (step, k)
        for name_, tree in want_state.items():
            if isinstance(tree, dict):
                for k in tree:
                    assert torch.equal(got_state[name_][k], tree[k]), (step, name_, k)
    lrs = {opt.schedule(s) for s in range(20)}
    assert len(lrs) >= 5  # the warmup and the staircase's steps
    if clip:
        assert min(norms) < clip < max(norms)


def test_clip_keeps_gradients_below_the_bound_bit_for_bit():
    """Below the bound the clip divides by 1 and multiplies by 1: the
    gradients, signed zeros included, come back as they were."""
    g = [torch.tensor([0.0, -0.0, 1e-30, -3.5e-3]), torch.tensor([[2.0, -1.0]])]
    out = tstate.clip_by_global_norm(g, 10.0)
    for a, b in zip(out, g):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
    clipped = tstate.clip_by_global_norm(g, 1.0)
    for a, b in zip(clipped, g):
        assert torch.equal(a, (b / norm) * 1.0)


# -------------------------------------------------------------- the card

@pytest.mark.cuda
def test_graphs_equal_the_eager_path_on_the_card(tmp_path):
    """One detect loop (4 batches at K = 2 and a batch alone) and train
    loops (5 steps at K = 2: two groups of two, one step alone; plain,
    with ``remat``, with two microbatches, and Adam with clipping) with the
    kernels (``use_pallas=True``), captured as CUDA graphs, bit for bit
    against the eager path; the launch counts equal.

    At this size (75 px, batch 2) cuDNN's default backward algorithms do
    not sum in a fixed order: two eager runs of one step differ in about
    200 leaves on an H100. The comparison therefore runs with
    ``cudnn.deterministic``, under which two eager runs agree bit for bit;
    ``chip_smoke.py``'s phase ``graphs`` holds the full-width steps with
    the default algorithms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU counterpart")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _graphs_against_eager(tmp_path)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _graphs_against_eager(tmp_path):
    from multibox_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    cfg = Config(**dict(DETECT, use_pallas=True, steps_per_host_transfer=2))
    model = tinf.build_model(cfg, 16, device=dev)
    variables = model.init_variables(torch.Generator().manual_seed(0))
    variables = {c: {k: v.to(dev) for k, v in t.items()} for c, t in variables.items()}
    priors = np.sort(np.random.default_rng(0).uniform(0.05, 0.95, (16, 2, 2)).astype(
        np.float32), axis=1).reshape(16, 4)
    data = detect_batches(np.random.default_rng(1), batches=5)
    packed = {}
    for eager in (True, False):
        fns = tinf.make_detect_loop_fns(cfg, priors, device=dev, eager=eager)
        seen, real = [], tinf._unpack_dets
        tinf._unpack_dets = lambda a: (seen.append(a.copy()), real(a))[1]
        try:
            kernels.reset_launch_counts()
            tinf.run_detect_loop(cfg, variables, data, priors, fns=fns)
            torch.cuda.synchronize()
        finally:
            tinf._unpack_dets = real
        packed[eager] = (np.stack(seen), kernels.launch_counts())
    assert packed[True][0].tobytes() == packed[False][0].tobytes()
    assert packed[True][1] == packed[False][1] and packed[True][1]["nms"] == 5

    tdata = train_batches(np.random.default_rng(2), 5)
    for extra in ({}, {"remat": True}, {"grad_accum_steps": 2}, {"optimizer": "adam",
                                                                   "clip_gradient_norm": 1.0}):
        tcfg = small_cfg(use_pallas=True, steps_per_host_transfer=2, **extra)
        states = {}
        for eager in (True, False):
            kernels.reset_launch_counts()
            logdir = str(tmp_path / f"eager{eager}")
            try:
                states[eager] = (train_from_batches(tcfg, tdata, PRIORS, logdir, max_steps=5,
                                                    device=dev, eager=eager),
                                 kernels.launch_counts())
            finally:
                remove_checkpoints(logdir)
        assert states[True][1] == states[False][1] and states[True][1]["match"] == \
            5 * tcfg.grad_accum_steps, extra
        assert_bitwise(states[True][0], states[False][0])


# every span of the package (``utils.spans``)
SPANS = {"prefetch.wait", "detect.loop", "detect.dispatch", "detect.drain", "detect.drain.wait",
         "train.group", "graphs.capture", "graphs.stage", "graphs.stage.wait", "graphs.replay"}


@pytest.mark.cuda
def test_graphed_steps_span_each_group_and_count_one_capture_an_owner():
    """A graphed detect loop (4 batches at K = 2) and graphed train groups
    (two steps at K = 2), each run once to capture and again on the same
    shapes, then a graph captured with the default owner: one capture an
    owner. Under ``torch.profiler``: a ``graphs.stage``,
    ``graphs.stage.wait`` and ``graphs.replay`` a group, and no span among
    the device's work (the ranges that host spans leave on the device's
    timeline are user annotations)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU counterpart")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multibox_tpu_torch import graphs
    from multibox_tpu_torch.train.loop import GraphedTrainStep, make_augmented_train_step

    dev = torch.device("cuda")
    graphs.reset_capture_counts()
    cfg = Config(**dict(DETECT, use_pallas=True, steps_per_host_transfer=2))
    model = tinf.build_model(cfg, 16, device=dev)
    variables = model.init_variables(torch.Generator().manual_seed(0))
    variables = {c: {k: v.to(dev) for k, v in t.items()} for c, t in variables.items()}
    priors = np.sort(np.random.default_rng(0).uniform(0.05, 0.95, (16, 2, 2)).astype(
        np.float32), axis=1).reshape(16, 4)
    data = detect_batches(np.random.default_rng(1), batches=4)
    fns = tinf.make_detect_loop_fns(cfg, priors, device=dev)
    loop = lambda: tinf.run_detect_loop(cfg, variables, data, priors, fns=fns)  # noqa: E731
    loop()

    tcfg = small_cfg(use_pallas=True, steps_per_host_transfer=2)
    tmodel = tinf.build_model(tcfg, len(PRIORS), device=dev)
    state = tstate.create_train_state(tcfg, tmodel, tcfg.seed, len(PRIORS), device=dev)
    steps = GraphedTrainStep(make_augmented_train_step(tcfg, tmodel, PRIORS, device=dev))
    tdata = train_batches(np.random.default_rng(2), 6)
    state, _ = steps(state, tdata[:2])

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop()
        steps(state, tdata[2:4])
        torch.cuda.synchronize()
    steps(state, tdata[4:])
    other = graphs.CapturedGraph(lambda: torch.ones(8, device=dev) * 2, dev)
    other.replay()
    assert other.outputs.tolist() == [2.0] * 8
    counts = graphs.capture_counts()
    assert {k: c["captures"] for k, c in counts.items()} == {"detect": 1, "train": 1, "other": 1}
    assert all(c["warmup_s"] > 0 and c["capture_s"] > 0 for c in counts.values())

    host, device = {}, []
    for e in prof.events():
        if e.name not in SPANS:
            continue
        if e.device_type == DeviceType.CPU:
            host[e.name] = host.get(e.name, 0) + 1
        elif not e.is_user_annotation:
            device.append(e.name)
    # two detect groups and one train group
    assert host == {"detect.loop": 1, "detect.dispatch": 2, "detect.drain": 2,
                    "detect.drain.wait": 2, "prefetch.wait": 5, "train.group": 1,
                    "graphs.stage": 3, "graphs.stage.wait": 3, "graphs.replay": 3}
    assert not device
