"""The plain reference against the program at a small size on the CPU: the
same tensors by name and shape, the same forward pass in float32 (eval and
train mode), the same augmentation draws, the same NMS selection and the
same loss. The tests may import the program; the reference may not."""

import numpy as np
import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import detect as ref_detect
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.tests.tiny import tiny_cell
from multibox_tpu_torch.data import augment
from multibox_tpu_torch.inference import build_model
from multibox_tpu_torch.models import detector
from multibox_tpu_torch.ops.nms import batched_nms
from multibox_tpu_torch.train.loss import multibox_loss

CELLS = ["multibox_inception_v3.detect_b4096", "ssd_inception_v3.train_b32"]


@pytest.fixture(params=CELLS)
def cell(request):
    torch.manual_seed(0)
    return tiny_cell(request.param)


def _program(cell, dtype="float32"):
    c = tiny_cell(cell.name)
    c.config["model"]["compute_dtype"] = dtype
    cfg = harness.port_config(c.config, c.traffic, 3)
    return cfg, build_model(cfg, cfg.num_priors, device="cpu")


def test_same_tensors(cell):
    _, model = _program(cell)
    shapes, stat_shapes = ref_model.parameter_shapes(harness.model_spec(cell.config))
    assert shapes == {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert stat_shapes == {n: tuple(b.shape) for n, b in model.named_buffers()}


@pytest.mark.parametrize("train", [False, True])
def test_forward_against_the_program(cell, train):
    spec = harness.model_spec(cell.config)
    cfg, model = _program(cell)
    params, stats = inputs.make_weights(spec, 5, "cpu")
    stats = {k: v + 0.1 * torch.rand_like(v) for k, v in stats.items()}
    x = torch.rand(4, spec["input_size"], spec["input_size"], 3) * 2 - 1
    new_stats = {}
    loc, conf = ref_model.forward(spec, params, stats, x, train=train, new_stats=new_stats)
    out = detector.apply(model, {"params": params, "batch_stats": stats}, x, train=train)
    if train:
        (ploc, pconf), pstats = out
        for k, v in pstats.items():
            torch.testing.assert_close(new_stats[k], v, rtol=1e-5, atol=1e-6)
    else:
        ploc, pconf = out
    torch.testing.assert_close(loc, ploc, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(conf, pconf, rtol=1e-4, atol=1e-4)


def test_the_control_reads_lower_precision(cell):
    spec = harness.model_spec(cell.config)
    params, stats = inputs.make_weights(spec, 5, "cpu")
    x = torch.rand(2, spec["input_size"], spec["input_size"], 3) * 2 - 1
    loc, conf = ref_model.forward(spec, params, stats, x)
    cloc, cconf = ref_model.forward(spec, params, stats, x, ref_model.CONTROL)
    gap = float((cconf - conf).abs().max())
    assert 1e-3 < gap < 2.0


def test_augmentation_draws_and_arithmetic_are_the_program_s():
    cell = tiny_cell("multibox_inception_v3.train_b32")
    cfg, _ = _program(cell)
    pool = inputs.make_train_pool(cell.traffic, 9, "cpu")
    for step, batch in enumerate(pool[:3]):
        b = {k: torch.as_tensor(v) for k, v in batch.items()}
        g1 = torch.Generator().manual_seed(ref_train.step_seed(9, step))
        g2 = torch.Generator().manual_seed(ref_train.step_seed(9, step))
        got = augment.augment_batch(g1, b["images"], b["boxes"], b["num_boxes"], cfg)
        want = ref_train.augment(g2, b["images"], b["boxes"], b["num_boxes"],
                                 cell.config["train"], cfg.input_size)
        for a, w in zip(got, want):
            assert torch.equal(a.to(w.dtype), w)


def test_nms_selects_the_program_s_boxes():
    rng = np.random.default_rng(4)
    cy, cx, h, w = (rng.uniform(0.1, 0.9, (3, 300)) for _ in range(4))
    boxes = torch.as_tensor(np.clip(np.stack([cy - h / 4, cx - w / 4, cy + h / 4, cx + w / 4], -1),
                                    0, 1), dtype=torch.float32)
    scores = torch.as_tensor(rng.uniform(0, 1, (3, 300)), dtype=torch.float32)
    want = batched_nms(boxes, scores, 20, 0.5, 0.3)[2]
    got = ref_detect.greedy_nms(boxes, scores, 20, 0.5, 0.3)
    assert torch.equal(got.to(torch.int32), want)


@pytest.mark.parametrize("name", ["multibox_inception_v3.train_b32", "ssd_inception_v3.train_b32"])
def test_loss_against_the_program(name):
    cell = tiny_cell(name)
    cfg, _ = _program(cell)
    spec = harness.model_spec(cell.config)
    priors = torch.as_tensor(inputs.make_priors(spec, 2))
    batch = inputs.make_train_pool(cell.traffic, 2, "cpu")[0]
    boxes, num = torch.as_tensor(batch["boxes"]), torch.as_tensor(batch["num_boxes"])
    B, P = boxes.shape[0], priors.shape[0]
    loc = 0.1 * torch.randn(B, P, 4)
    conf = 2 * torch.randn(B, P)
    want = multibox_loss(loc, conf, boxes, num, priors, alpha=cfg.location_loss_alpha,
                         matching=cfg.matching, hard_negative_ratio=cfg.hard_negative_ratio,
                         multi_match_iou=cfg.multi_match_iou, encode=cfg.box_encoding)[0]
    tc = {**cell.config["train"], "box_encoding": spec["box_encoding"]}
    got = ref_train.multibox_loss(loc, conf, boxes, num.to(torch.int64), priors, tc)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
