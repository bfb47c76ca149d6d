"""``models/tf_import.py`` and the pretrained restore of ``train()`` against
the JAX package on the CPU.

One tf-slim checkpoint, written by TensorFlow with slim's variable names
(the ``Mixed_5c`` / ``Mixed_7c`` quirks included) and EMA shadows of the
kernels, as ``tests/test_slim_import.py`` writes it, at the shapes of the
backbone at 75 px (some 175 MB; one for the module). The port's import
must equal ``flax_to_torch`` of the JAX package's import exactly, raw and
EMA; the keras route likewise, and the port's backbone forward on the
keras weights matches the JAX one within ``tests/test_torch_model.py``'s
tolerance (atol 1e-4, and 1e-3 of the largest activation).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import functional_call

from multibox_tpu.models import tf_import as jimport
from multibox_tpu.models.inception_v3 import InceptionV3 as JInceptionV3
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.data.example_proto import build_detection_example
from multibox_tpu_torch.data.jpeg import encode_jpeg
from multibox_tpu_torch.data.tfrecord import TFRecordWriter
from multibox_tpu_torch.inference import build_model
from multibox_tpu_torch.models import convert, inception_v3
from multibox_tpu_torch.models import tf_import as timport
from multibox_tpu_torch.train import create_train_state
from multibox_tpu_torch.train.loop import train
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SIZE = 75


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(dict(tree)))


@pytest.fixture(scope="module")
def jvars():
    """The JAX package's backbone variables at 75 px, as numpy zeros of
    their shapes (every leaf is a conv unit's, and each import overwrites
    all of them)."""
    shapes = jax.eval_shape(JInceptionV3(compute_dtype=jnp.float32).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), dict(shapes))


@pytest.fixture(scope="module")
def slim_ckpt(jvars, tmp_path_factory):
    tf = pytest.importorskip("tensorflow")
    import flax

    params = flax.traverse_util.flatten_dict(jvars["params"])
    rng = np.random.default_rng(0)
    tf1 = tf.compat.v1
    graph = tf.Graph()
    with graph.as_default():
        for unit in jimport.conv_unit_order():
            slim = f"InceptionV3/{jimport._slim_name(unit)}"
            path = jimport._unit_path((), unit)
            kshape = params[path + ("Conv", "kernel")].shape
            cshape = params[path + ("BatchNorm", "bias")].shape
            for name, shape in [(f"{slim}/weights", kshape), (f"{slim}/BatchNorm/beta", cshape),
                                (f"{slim}/BatchNorm/moving_mean", cshape)]:
                tf1.get_variable(name, initializer=rng.normal(0, 0.05, shape).astype(np.float32))
            tf1.get_variable(f"{slim}/BatchNorm/moving_variance",
                             initializer=rng.uniform(0.5, 1.5, cshape).astype(np.float32))
            tf1.get_variable(f"{slim}/weights/ExponentialMovingAverage",
                             initializer=rng.normal(0, 0.05, kshape).astype(np.float32))
        saver = tf1.train.Saver()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            return saver.save(sess, str(tmp_path_factory.mktemp("slim") / "inception_v3.ckpt"))


def assert_variables_equal(got, want):
    assert set(got) == set(want)
    for coll in want:
        assert set(got[coll]) == set(want[coll]), coll
        for k, v in want[coll].items():
            assert got[coll][k].dtype == v.dtype and torch.equal(got[coll][k], v), k


def test_unit_order_and_slim_names_are_the_jax_packages():
    units = timport.conv_unit_order()
    assert units == jimport.conv_unit_order() and len(units) == 94
    assert [timport._slim_name(u) for u in units] == [jimport._slim_name(u) for u in units]
    # the quirks as literals (the checkpoint fixture is written with them)
    assert timport._slim_name("Mixed_5c/Branch_1/Conv2d_0a_1x1") == \
        "Mixed_5c/Branch_1/Conv2d_0b_1x1"
    assert timport._slim_name("Mixed_5c/Branch_1/Conv2d_0b_5x5") == \
        "Mixed_5c/Branch_1/Conv_1_0c_5x5"
    assert timport._slim_name("Mixed_7c/Branch_1/Conv2d_0b_3x1") == \
        "Mixed_7c/Branch_1/Conv2d_0c_3x1"
    assert timport._slim_name("Mixed_7b/Branch_1/Conv2d_0b_3x1") == \
        "Mixed_7b/Branch_1/Conv2d_0b_3x1"


@pytest.mark.parametrize("use_ema", [False, True], ids=["raw", "ema"])
def test_slim_import_is_flax_to_torch_of_the_jax_import(jvars, slim_ckpt, use_ema):
    tvars = convert.flax_to_torch(jvars, device="cpu")
    before = {c: {k: v.clone() for k, v in d.items()} for c, d in tvars.items()}
    got = timport.import_slim_checkpoint(slim_ckpt, tvars, use_ema=use_ema)
    want = convert.flax_to_torch(
        numpy_tree(jimport.import_slim_checkpoint(slim_ckpt, jvars, use_ema=use_ema)),
        device="cpu")
    assert_variables_equal(got, want)
    assert_variables_equal(tvars, before)  # the input is not written
    key = "Mixed_5c.Branch_1/Conv2d_0b_5x5.Conv.weight"  # a quirk unit, OIHW
    assert got["params"][key].shape == (64, 48, 5, 5)
    assert not torch.equal(got["params"][key], before["params"][key])


def test_slim_import_into_a_detector_keeps_its_head(jvars, slim_ckpt):
    model = build_model(Config(input_size=SIZE, num_priors=8, compute_dtype="float32"), 8,
                        device="cpu")
    dvars = model.init_variables(torch.Generator().manual_seed(0))
    got = timport.import_slim_checkpoint(slim_ckpt, dvars)
    bare = timport.import_slim_checkpoint(slim_ckpt, convert.flax_to_torch(jvars,
                                                                          device="cpu"))
    for coll in ("params", "batch_stats"):
        for k, v in got[coll].items():
            if k.startswith("InceptionV3."):
                assert torch.equal(v, bare[coll][k[len("InceptionV3."):]]), k
            else:
                assert v is dvars[coll][k], k  # the head as it was
    assert any(k.startswith("MultiBoxHead.") for k in got["params"])


def test_slim_import_refuses_a_missing_variable_and_a_wrong_shape(jvars, slim_ckpt, tmp_path):
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    graph = tf.Graph()
    with graph.as_default():
        tf1.get_variable("InceptionV3/Conv2d_1a_3x3/weights",
                         initializer=np.zeros((3, 3, 3, 32), np.float32))
        saver = tf1.train.Saver()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            partial = saver.save(sess, str(tmp_path / "partial.ckpt"))
    tvars = convert.flax_to_torch(jvars, device="cpu")
    with pytest.raises(KeyError, match="BatchNorm/beta"):
        timport.import_slim_checkpoint(partial, tvars)
    tvars["params"]["Conv2d_1a_3x3.Conv.weight"] = torch.zeros(32, 3, 5, 5)
    with pytest.raises(ValueError, match="shape mismatch"):
        timport.import_slim_checkpoint(slim_ckpt, tvars)


def test_keras_import_is_exact_and_the_backbone_matches_jax_on_it(jvars):
    tf = pytest.importorskip("tensorflow")
    keras_model = tf.keras.applications.InceptionV3(weights=None, include_top=False,
                                                    input_shape=(SIZE, SIZE, 3))
    tvars = convert.flax_to_torch(jvars, device="cpu")
    got = timport.import_keras_inception_v3(keras_model, tvars)
    jimported = jimport.import_keras_inception_v3(keras_model, jvars)
    assert_variables_equal(got, convert.flax_to_torch(numpy_tree(jimported), device="cpu"))

    x = np.random.default_rng(1).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = JInceptionV3(compute_dtype=jnp.float32).apply(jimported, jnp.asarray(x))
    net = inception_v3.InceptionV3(compute_dtype=torch.float32)
    with torch.no_grad():
        eps = functional_call(net, {**got["params"], **got["batch_stats"]},
                              (torch.from_numpy(x),))
    for name in ("Mixed_5d", "Mixed_6e", "Mixed_7c"):
        w, g = np.asarray(want[name]), eps[name].numpy()
        np.testing.assert_allclose(g, w, atol=1e-4)
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()


def test_train_restores_a_slim_backbone_and_keeps_the_head(slim_ckpt, tmp_path):
    """``train(..., pretrained_model=<slim checkpoint>)``: the backbone's
    params and statistics are the checkpoint's, the EMA params a copy of
    the params, the head as initialized."""
    cfg = Config(input_size=SIZE, num_priors=8, batch_size=2, max_num_bboxes=3,
                 compute_dtype="float32", save_every_steps=100)
    priors = np.sort(np.random.default_rng(0).uniform(0.05, 0.95, (8, 2, 2)).astype(
        np.float32), axis=1).reshape(8, 4)
    records = str(tmp_path / "train.tfrecord")
    with TFRecordWriter(records) as w:
        for i in range(2):
            w.write(build_detection_example(
                encode_jpeg(np.full((40, 40, 3), 60 * i, np.uint8)), f"im{i}",
                np.array([[0.1, 0.2, 0.6, 0.7]], np.float32), labels=[1]))
    logdir = tmp_path / "run"
    try:
        state = train(cfg, [records], priors, str(logdir), pretrained_model=slim_ckpt,
                      max_steps=0, device="cpu")
    finally:
        for name in os.listdir(logdir) if logdir.exists() else []:
            if name.endswith(".pt"):
                os.remove(logdir / name)
    fresh = create_train_state(cfg, build_model(cfg, 8, device="cpu"), cfg.seed, 8,
                               device="cpu")
    want = timport.import_slim_checkpoint(
        slim_ckpt, {"params": fresh.params, "batch_stats": fresh.batch_stats})
    assert state.step == 0
    for k, v in state.params.items():
        assert torch.equal(v, want["params"][k]), k
        assert torch.equal(state.ema_params[k], v), k
        if k.startswith("MultiBoxHead."):
            assert torch.equal(v, fresh.params[k]), k
        else:
            assert not torch.equal(v, fresh.params[k]), k
    for k, v in state.batch_stats.items():
        assert torch.equal(v, want["batch_stats"][k]), k
