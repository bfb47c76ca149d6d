"""The port's training surface around the step, on the CPU: learning-rate
schedules and optimizers against optax, train-time augmentation against
the JAX package on replayed random draws, the checkpoint manager, the
chunked and rematerialized steps, and ``train_from_batches()`` resuming.

Tolerances: schedules rtol 1e-6 (float32 arithmetic in both); optimizers
1e-6 after five steps (float32 rsqrt/sqrt rounding); augmentation images
1e-5 (float32 pixel arithmetic in another order: the JAX package resizes
with two interpolation products, the port gathers the two taps), boxes
1e-6, counts and permutations exact. Port against itself (resume,
chunking, remat): exact, the same operations on the same CPU.
"""

import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from multibox_tpu.config import Config as JConfig
from multibox_tpu.data import augment as jaug
from multibox_tpu.train import state as jstate
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.data import augment as taug
from multibox_tpu_torch.inference import build_model
from multibox_tpu_torch.train import state as tstate
from multibox_tpu_torch.train.loop import (
    make_augmented_train_step,
    make_chunked_step,
    step_generator,
    train_from_batches,
)
from multibox_tpu_torch.utils.checkpoint import CheckpointManager
from tests.conftest import random_boxes
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- schedules

@pytest.mark.parametrize("kw", [
    dict(lr_schedule="exponential", num_train_examples=64, batch_size=8,
         num_epochs_per_decay=0.5, learning_rate_decay_factor=0.5, min_learning_rate=0.02),
    dict(lr_schedule="exponential", learning_rate_decay_factor=0.0),
    dict(lr_schedule="cosine", max_number_of_steps=20, min_learning_rate=0.01),
    dict(lr_schedule="cosine", max_number_of_steps=20, warmup_steps=5),
    dict(lr_schedule="exponential", num_train_examples=64, batch_size=8,
         num_epochs_per_decay=0.5, warmup_steps=3),
], ids=["staircase_end_value", "zero_rate_constant", "cosine_alpha", "cosine_warmup",
        "staircase_warmup"])
def test_lr_schedules_match_optax(kw):
    kw = dict(initial_learning_rate=0.1, **kw)
    want = jstate.make_lr_schedule(JConfig(**kw))
    got = tstate.make_lr_schedule(Config(**kw))
    for step in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 19, 20, 25, 100):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


# ------------------------------------------------------------ optimizers

@pytest.mark.parametrize("clip", [0.0, 3.0], ids=["noclip", "clip3"])
@pytest.mark.parametrize("name", ["rmsprop", "momentum", "sgd", "adam"])
def test_optimizers_match_optax(name, clip):
    """Five steps of fixed gradients; rmsprop at its default ε = 1.0 (the
    ε-inside-the-root case ``torch.optim.RMSprop`` gets wrong)."""
    kw = dict(optimizer=name, initial_learning_rate=0.1, num_train_examples=64,
              batch_size=8, num_epochs_per_decay=0.5, clip_gradient_norm=clip,
              rmsprop_epsilon=1.0)
    rng = np.random.default_rng(1)
    tx = jstate.make_optimizer(JConfig(**kw))
    opt = tstate.make_optimizer(Config(**kw))
    p0 = {"a": rng.normal(0, 1, (5, 3)).astype(np.float32),
          "b": rng.normal(0, 1, 7).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    tp = {k: t(v) for k, v in p0.items()}
    ts = opt.init(tp)
    for _ in range(5):
        g = {k: rng.normal(0, 2, v.shape).astype(np.float32) for k, v in p0.items()}
        u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        opt.apply(tp, {k: t(v) for k, v in g.items()}, ts)
    assert ts["count"] == 5
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)


def test_rmsprop_is_not_torch_optim_rmsprop():
    """The trap the port avoids: ε inside the root, ν from 0 (step 1 of
    g = −2 at lr 0.1: optax moves 0.1690, ``torch.optim.RMSprop`` 0.1225)."""
    cfg = Config(initial_learning_rate=0.1, rmsprop_momentum=0.0)
    opt = tstate.make_optimizer(cfg)
    p = {"w": torch.zeros(1)}
    opt.apply(p, {"w": torch.tensor([-2.0])}, opt.init(p))
    assert float(p["w"]) == pytest.approx(0.1690, abs=1e-4)
    w = torch.zeros(1, requires_grad=True)
    torch_opt = torch.optim.RMSprop([w], lr=0.1, alpha=0.9, eps=1.0)
    w.grad = torch.tensor([-2.0])
    torch_opt.step()
    assert float(w.detach()) == pytest.approx(0.1225, abs=1e-4)


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tstate.make_optimizer(Config(optimizer="adagrad"))


# ---------------------------------------------------------- augmentation

def boxes_batch(rng, B, G):
    return np.stack([random_boxes(rng, G) for _ in range(B)]).astype(np.float32)


def test_crop_and_resize_and_box_transform_match_jax():
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (3, 40, 53, 3)).astype(np.float32)
    lo = rng.uniform(0, 0.4, (3, 2))
    windows = np.concatenate([lo, lo + rng.uniform(0.3, 0.6, (3, 2))], 1).astype(np.float32)
    want = jaug.crop_and_resize(jnp.asarray(images), jnp.asarray(windows), 29)
    got = taug.crop_and_resize(t(images), t(windows), 29)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)
    boxes = boxes_batch(rng, 3, 6)
    num = np.array([6, 3, 0], np.int32)
    want = jax.vmap(jaug.transform_boxes_to_window)(
        jnp.asarray(boxes), jnp.asarray(num), jnp.asarray(windows))
    got = taug.transform_boxes_to_window(t(boxes), t(num), t(windows))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def jax_crop_draws(key, K=16, area_range=(0.5, 1.0), aspect_range=(0.75, 1.33)):
    """The draws of ``sample_crop_window``, made as it makes them."""
    k_area, k_ar, k_pos = jax.random.split(key, 3)
    return {
        "area": np.asarray(jax.random.uniform(k_area, (K,), minval=area_range[0],
                                              maxval=area_range[1])),
        "log_aspect": np.asarray(jax.random.uniform(
            k_ar, (K,), minval=jnp.log(aspect_range[0]), maxval=jnp.log(aspect_range[1]))),
        "uv": np.asarray(jax.random.uniform(k_pos, (K, 2))),
    }


def jax_augment_draws(key, B, cfg):
    """Every draw of ``augment_batch``, in the port's parameter layout."""
    k_crop, k_flip, k_color = jax.random.split(key, 3)
    crops = [jax_crop_draws(k, area_range=(cfg.crop_min_area, cfg.crop_max_area))
             for k in jax.random.split(k_crop, B)]
    kb, kc, ks, kh = jax.random.split(k_color, 4)
    return {
        "crop": {n: t(np.stack([c[n] for c in crops])) for n in crops[0]},
        "flip": t(np.asarray(jax.random.bernoulli(k_flip, 0.5, (B,)))),
        "color": {
            "brightness": t(np.asarray(jax.random.uniform(
                kb, (B, 1, 1, 1), minval=-cfg.brightness_max_delta,
                maxval=cfg.brightness_max_delta)).reshape(B)),
            "contrast": t(np.asarray(jax.random.uniform(
                kc, (B, 1, 1, 1), minval=cfg.contrast_range[0],
                maxval=cfg.contrast_range[1])).reshape(B)),
            "saturation": t(np.asarray(jax.random.uniform(
                ks, (B, 1, 1, 1), minval=0.5, maxval=1.5)).reshape(B)),
            "hue": t(np.asarray(jax.random.uniform(
                kh, (B,), minval=-cfg.hue_max_delta, maxval=cfg.hue_max_delta)
                * (2.0 * jnp.pi))),
        },
    }


def test_sample_crop_window_and_color_distort_match_jax_on_its_draws():
    rng = np.random.default_rng(3)
    boxes = boxes_batch(rng, 4, 5)
    num = np.array([5, 1, 0, 3], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = np.stack([np.asarray(jaug.sample_crop_window(k, jnp.asarray(b), jnp.int32(n)))
                     for k, b, n in zip(keys, boxes, num)])
    draws = [jax_crop_draws(k) for k in keys]
    params = {n: t(np.stack([d[n] for d in draws])) for n in draws[0]}
    got = taug.sample_crop_window(params, t(boxes), t(num))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    cfg = JConfig()
    images = rng.uniform(0, 1, (4, 9, 11, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jaug.color_distort(key, jnp.asarray(images), cfg)
    color = jax_augment_draws(jax.random.fold_in(key, 0), 4, cfg)["color"]
    # color_distort splits its own key in four; replay those draws
    kb, kc, ks, kh = jax.random.split(key, 4)
    color = {
        "brightness": t(np.asarray(jax.random.uniform(kb, (4, 1, 1, 1), minval=-0.125,
                                                      maxval=0.125)).reshape(4)),
        "contrast": t(np.asarray(jax.random.uniform(kc, (4, 1, 1, 1), minval=0.5,
                                                    maxval=1.5)).reshape(4)),
        "saturation": t(np.asarray(jax.random.uniform(ks, (4, 1, 1, 1), minval=0.5,
                                                      maxval=1.5)).reshape(4)),
        "hue": t(np.asarray(jax.random.uniform(kh, (4,), minval=-0.05, maxval=0.05)
                            * (2.0 * jnp.pi))),
    }
    got = taug.color_distort(color, t(images), Config())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    theta = np.array([0.0, 0.3, -1.0, 2.0], np.float32)
    np.testing.assert_allclose(
        taug._rotate_hue(t(images), t(theta)).numpy(),
        np.asarray(jaug._rotate_hue(jnp.asarray(images), jnp.asarray(theta))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_labels", [False, True], ids=["boxes", "labels"])
def test_augment_batch_matches_jax_on_its_draws(with_labels):
    rng = np.random.default_rng(5)
    B, G = 4, 5
    cfg = JConfig(input_size=31)
    images = rng.integers(0, 256, (B, 36, 36, 3)).astype(np.uint8)
    boxes = boxes_batch(rng, B, G)
    num = np.array([5, 2, 0, 4], np.int32)
    labels = rng.integers(0, 7, (B, G)).astype(np.int32) if with_labels else None
    key = jax.random.PRNGKey(11)
    want = jaug.augment_batch(key, jnp.asarray(images), jnp.asarray(boxes),
                              jnp.asarray(num), cfg,
                              labels=None if labels is None else jnp.asarray(labels))
    got = taug.apply_augment(jax_augment_draws(key, B, cfg), t(images), t(boxes), t(num),
                             Config(input_size=31),
                             labels=None if labels is None else t(labels))
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if with_labels:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_augment_batch_is_seeded_by_its_generator():
    cfg = Config(input_size=31)
    rng = np.random.default_rng(6)
    images = t(rng.integers(0, 256, (2, 36, 36, 3)).astype(np.uint8))
    boxes, num = t(boxes_batch(rng, 2, 3)), torch.tensor([3, 1])
    a = taug.augment_batch(step_generator(0, 7, "cpu"), images, boxes, num, cfg)
    b = taug.augment_batch(step_generator(0, 7, "cpu"), images, boxes, num, cfg)
    c = taug.augment_batch(step_generator(0, 8, "cpu"), images, boxes, num, cfg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (2, 31, 31, 3) and float(a[0].abs().max()) <= 1.0


# ------------------------------------------------------------- checkpoint

def small_cfg(**kw):
    base = dict(input_size=75, num_priors=8, batch_size=2, max_num_bboxes=3,
                compute_dtype="float32", initial_learning_rate=0.003,
                num_train_examples=2, log_every_steps=1, save_every_steps=1)
    base.update(kw)
    return Config(**base)


def small_state(cfg, seed=0):
    model = build_model(cfg, 8, device="cpu")
    return model, tstate.create_train_state(cfg, model, seed, 8, device="cpu")


def toy_state(seed):
    """A train state of a few small tensors (a checkpoint of the whole
    Inception-v3 state is some 350 MB)."""
    g = torch.Generator().manual_seed(seed)
    params = {"MultiBoxHead.Locations.bias": torch.randn(8, generator=g).requires_grad_(True),
              "InceptionV3.Conv2d_1a_3x3.Conv.weight": torch.randn(4, 3, 3, 3, generator=g)
              .requires_grad_(True)}
    stats = {"InceptionV3.Conv2d_1a_3x3.BatchNorm.mean": torch.randn(4, generator=g)}
    opt = tstate.make_optimizer(small_cfg())
    return tstate.TrainState(0, params, stats, opt.init(params),
                             {k: v.detach().clone() for k, v in params.items()})


def test_checkpoint_manager_keeps_saves_and_restores(tmp_path):
    state = toy_state(0)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, save_every=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state, device="cpu")
    assert not mgr.save(1, state)  # not on the cadence
    for step in (2, 4, 6):
        state.step = step
        with torch.no_grad():
            state.params["MultiBoxHead.Locations.bias"].fill_(float(step))
        assert mgr.save(step, state)
    assert not mgr.save(6, state)  # already saved
    assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path / "ck"))
    state.step = 7
    assert mgr.save(7, state, force=True) and mgr.all_steps() == [6, 7]
    back = mgr.restore(toy_state(1), step=6, device="cpu")
    assert back.step == 6
    assert float(back.params["MultiBoxHead.Locations.bias"][0]) == 6.0
    assert back.params["MultiBoxHead.Locations.bias"].requires_grad
    assert not back.ema_params["MultiBoxHead.Locations.bias"].requires_grad
    for k, v in state.batch_stats.items():
        assert torch.equal(back.batch_stats[k], v)
    raw = mgr.restore_raw(device="cpu")
    assert raw["step"] == 7 and set(raw) == {"step", "params", "batch_stats",
                                             "opt_state", "ema_params"}
    mgr.wait()
    mgr.close()


# ------------------------------------------------------------------ steps

def host_batches(n, seed=7, canvas=86):
    rng = np.random.default_rng(seed)
    return [{
        "images": rng.integers(0, 256, (2, canvas, canvas, 3)).astype(np.uint8),
        "boxes": boxes_batch(rng, 2, 3),
        "num_boxes": np.array([3, 1], np.int32),
    } for _ in range(n)]


PRIORS = np.sort(np.random.default_rng(0).uniform(0.05, 0.95, (8, 2, 2)).astype(np.float32),
                 axis=1).reshape(8, 4)


def assert_states_equal(a, b):
    assert a.step == b.step
    for coll in ("params", "batch_stats", "ema_params"):
        for k, v in getattr(a, coll).items():
            assert torch.equal(v, getattr(b, coll)[k]), (coll, k)


def test_chunked_step_equals_the_sequential_one():
    cfg = small_cfg()
    model, s_seq = small_state(cfg)
    s_chunk = s_seq.clone()
    step = make_augmented_train_step(cfg, model, PRIORS, device="cpu")
    batches = host_batches(4)
    for b in batches:
        s_seq, m_seq = step(s_seq, b)
    chunk = make_chunked_step(step, 2)
    for k in (0, 2):
        sb = {key: np.stack([b[key] for b in batches[k:k + 2]]) for key in batches[0]}
        s_chunk, m_chunk = chunk(s_chunk, sb)
    assert s_chunk.step == 4
    assert float(m_chunk["loss"]) == float(m_seq["loss"])
    assert_states_equal(s_seq, s_chunk)


def test_remat_step_equals_the_plain_step():
    cfg = small_cfg(augment=False)
    model, a = small_state(cfg)
    b = a.clone()
    batch = host_batches(1)[0]
    a, ma = make_augmented_train_step(cfg, model, PRIORS, device="cpu")(a, batch)
    rcfg = small_cfg(augment=False, remat=True)
    b, mb = make_augmented_train_step(rcfg, model, PRIORS, device="cpu")(b, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for k, v in a.params.items():
        torch.testing.assert_close(b.params[k], v, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ train

def read_metrics(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("chunk", [1, 2], ids=["per_step", "chunked"])
def test_train_resumes_from_its_checkpoint(tmp_path, chunk):
    """3 steps, then a second call to 5 restores step 3 and runs 2 more,
    ending where one uninterrupted 5-step run ends (the data stream and
    the augmentation generators are keyed by the step)."""
    # one checkpoint kept (each is some 350 MB), written at the end of a call
    cfg = small_cfg(steps_per_host_transfer=chunk, save_every_steps=100,
                    keep_checkpoints=1)
    data = host_batches(5)
    stream = lambda start: iter(data[start:])  # noqa: E731
    resumed, whole_dir = tmp_path / "resumed", tmp_path / "whole"
    try:
        first = train_from_batches(cfg, stream, PRIORS, str(resumed), max_steps=3,
                                   schedule_total=5, device="cpu")
        assert first.step == 3 and CheckpointManager(str(resumed)).latest_step() == 3
        second = train_from_batches(cfg, stream, PRIORS, str(resumed), max_steps=5,
                                    device="cpu")
        assert second.step == 5 and CheckpointManager(str(resumed)).all_steps() == [5]
        whole = train_from_batches(cfg, stream, PRIORS, str(whole_dir), max_steps=5,
                                   device="cpu")
        assert_states_equal(second, whole)
        assert second.opt_state["count"] == 5
        logged = read_metrics(str(resumed))
        assert [r["step"] for r in logged] == [1, 2, 3, 4, 5] if chunk == 1 else [2, 3, 5]
        assert all(np.isfinite(r["loss"]) for r in logged)
        assert {"loss", "loss_conf", "loss_loc", "learning_rate",
                "images_per_sec"} <= set(logged[-1])
    finally:
        for d in (resumed, whole_dir):
            for name in os.listdir(d) if d.exists() else []:
                if name.endswith(".pt"):
                    os.remove(d / name)


def test_warm_start_grafts_the_backbone_and_keeps_the_head(tmp_path):
    """A logdir of this package as ``pretrained_model``: the backbone's EMA
    shadows and statistics replace the fresh ones, the head stays, the EMA
    restarts from the grafted params (the JAX package's
    ``_warm_start_from_logdir``)."""
    from multibox_tpu_torch.train.loop import _restore_pretrained

    src = toy_state(0)
    with torch.no_grad():
        for v in src.ema_params.values():
            v.add_(0.5)
    logdir = str(tmp_path / "src_run")
    CheckpointManager(logdir).save(1, src, force=True)
    dst = toy_state(1)
    head = dst.params["MultiBoxHead.Locations.bias"].detach().clone()
    out = _restore_pretrained(dst, logdir, "cpu")
    key = "InceptionV3.Conv2d_1a_3x3.Conv.weight"
    assert torch.equal(out.params[key], src.ema_params[key])
    assert torch.equal(out.ema_params[key], out.params[key])
    assert torch.equal(out.params["MultiBoxHead.Locations.bias"], head)
    assert torch.equal(out.batch_stats["InceptionV3.Conv2d_1a_3x3.BatchNorm.mean"],
                       src.batch_stats["InceptionV3.Conv2d_1a_3x3.BatchNorm.mean"])
    bad = toy_state(2)
    bad.params[key] = torch.zeros(5, 3, 3, 3, requires_grad=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        _restore_pretrained(bad, logdir, "cpu")


def test_train_profiles_and_writes_image_summaries(tmp_path):
    """``profile_steps`` traces steps with torch.profiler into the logdir;
    ``image_summary_steps`` writes input canvases with their boxes burned
    in (TensorBoard events, where TensorFlow imports)."""
    cfg = small_cfg(profile_steps=1, image_summary_steps=1, save_every_steps=100,
                    keep_checkpoints=1, augment=False)
    logdir = tmp_path / "run"
    try:
        state = train_from_batches(cfg, host_batches(3), PRIORS, str(logdir), max_steps=3,
                                   device="cpu")
        assert state.step == 3
        assert (logdir / "trace.json").exists()
        assert [r["step"] for r in read_metrics(str(logdir))] == [1, 2, 3]
    finally:
        for name in os.listdir(logdir) if logdir.exists() else []:
            if name.endswith(".pt"):
                os.remove(logdir / name)


def test_burn_boxes_draws_the_box_outline():
    from multibox_tpu.utils.metrics import burn_boxes as jburn
    from multibox_tpu_torch.utils.metrics import burn_boxes

    images = np.zeros((2, 20, 30, 3), np.uint8)
    boxes = np.array([[[0.1, 0.2, 0.6, 0.9]], [[0.0, 0.0, 1.0, 1.0]]], np.float32)
    got = burn_boxes(images, boxes, np.array([1, 0]))
    np.testing.assert_array_equal(got, jburn(images, boxes, np.array([1, 0])))
    assert got[0].any() and not got[1].any()


def test_train_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """A ``pretrained_model`` that is neither a logdir of this package nor a
    readable checkpoint raises; without TensorFlow (the GPU machine has
    none) the slim and keras formats raise ``ImportError`` naming it."""
    cfg = small_cfg()
    with pytest.raises(Exception, match="model.ckpt"):
        train_from_batches(cfg, [], PRIORS, str(tmp_path / "b"), max_steps=1,
                           pretrained_model=str(tmp_path / "model.ckpt"), device="cpu")
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # import raises
    for name in ("model.ckpt", "model.h5", "model.keras"):
        with pytest.raises(ImportError, match="needs TensorFlow"):
            train_from_batches(cfg, [], PRIORS, str(tmp_path / "b"), max_steps=1,
                               pretrained_model=str(tmp_path / name), device="cpu")
