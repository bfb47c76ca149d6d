"""The port's int8 post-training quantization (``models/quant.py``,
``quantize.py``, the int8 detect path) against the JAX package's, on the CPU.

Tolerances and their reasons:

- ``quantize_conv_params``: exact (the same float32 division and
  round-half-even on the same values).
- ``QuantConv`` in int8 mode: the int32 accumulators exactly equal to the
  JAX package's convolution with ``preferred_element_type=int32`` on the
  same int8 operands; the outputs (the same float32 dequantization, op for
  op) within 2 ulps. In calibrate mode the updated ``x_scale`` exactly, the
  outputs rtol 1e-5 (a float32 convolution, summed in another order).
- Each route of ``int8_conv`` exact against an int64 reference in numpy.
- ``prepare_quantized_variables``: the quantized parameters exactly; the
  calibrated ``x_scale``s of the first unit exactly (the same preprocessed
  input) and of the later ones within 5e-6 relative: each unit's input
  comes through float32 convolutions summed in another order than XLA's,
  and the gap grows with depth (2.1e-6 at the worst of Inception's 94 units
  at 75 px, measured).
- int8 detect against the JAX int8 detect, scores and boxes: on the same
  prepared variables (converted from the JAX package's) atol 5e-4, each
  package preparing its own atol 2e-3; classes and counts exact. An
  activation that sits on a rounding boundary of ``round(x·127/scale)``
  lands on the other integer in one package when its input differs in the
  last bit (XLA may contract the dequantization's multiply-add into one
  rounding; with its own preparation the x_scales differ too), a change of
  one quantization step that later units carry on and compound over depth.
  Measured at 75 px, scores / boxes: Inception 6e-8 / 1.5e-8 on the same
  variables and 4e-6 / 1.9e-5 on its own; MobileNet 0.5 1.4e-5 / 1.1e-4
  and 3e-5 / 2.4e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp

from multibox_tpu.config import Config as JConfig
from multibox_tpu.data.augment import preprocess_eval as jpreprocess
from multibox_tpu.inference import build_model as jbuild_model
from multibox_tpu.inference import make_detect_body as jmake_detect_body
from multibox_tpu.models.quant import QuantConv as JQuantConv
from multibox_tpu.models.quant import quantize_conv_params as jquantize_conv_params
from multibox_tpu.quantize import prepare_quantized_variables as jprepare
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.data.augment import preprocess_eval
from multibox_tpu_torch.inference import build_model, make_detect_body
from multibox_tpu_torch.models import convert, quant
from multibox_tpu_torch.models.inception_v3 import ConvBN
from multibox_tpu_torch.models.mobilenet import ConvBNRelu6
from multibox_tpu_torch.quantize import (
    calib_batches_from_dataset,
    prepare_quantized_variables,
)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def hwio_to_oihw(w):
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def test_quantize_conv_params_is_exactly_the_jax_package(rng):
    w = rng.normal(0, 0.3, (3, 3, 8, 16)).astype(np.float32)
    w[..., 3] *= 10.0  # a hot channel keeps its own scale
    w[..., 5] = 0.0  # an all-zero channel: the 1e-12 floor
    w[0, 0, 0, 7] = 0.3 * 127 / 2  # exactly on a rounding boundary of its channel
    kq, ws = quant.quantize_conv_params(torch.from_numpy(hwio_to_oihw(w)))
    jkq, jws = jquantize_conv_params(w)
    assert kq.dtype == torch.int8 and ws.dtype == torch.float32
    np.testing.assert_array_equal(kq.numpy(), hwio_to_oihw(jkq))
    np.testing.assert_array_equal(ws.numpy(), jws)


# (kernel, strides, padding, groups, cin, cout): a 1×1 unit, SAME 3×3, the
# stride-2 VALID reduction, Inception's 1×7, the stem (3 channels), and
# MobileNet's depthwise at stride 2 on an even input (TF's (0, 1) padding)
UNITS = [((1, 1), (1, 1), "SAME", 1, 16, 8), ((3, 3), (1, 1), "SAME", 1, 8, 16),
         ((3, 3), (2, 2), "VALID", 1, 8, 24), ((1, 7), (1, 1), "SAME", 1, 16, 16),
         ((3, 3), (2, 2), "VALID", 1, 3, 32), ((3, 3), (2, 2), "SAME", 16, 16, 16)]
UNIT_IDS = ["1x1", "3x3_same", "3x3_s2_valid", "1x7", "stem", "depthwise_s2"]


def unit_operands(rng, kernel, groups, cin, cout, calibrate):
    x = rng.normal(0, 1.5, (2, 10, 10, cin)).astype(np.float32)
    w = rng.normal(0, 0.2, kernel + (cin // groups, cout)).astype(np.float32)
    kq, ws = jquantize_conv_params(w)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    x_scale = np.float32(0.75 if calibrate else 3.0)  # int8: some inputs clip
    return x, kq, ws, bias, x_scale


def run_both(x, kq, ws, bias, x_scale, kernel, strides, padding, groups, calibrate):
    cin, cout = x.shape[-1], kq.shape[-1]
    jmod = JQuantConv(cout, kernel, strides, padding, groups, calibrate=calibrate,
                      compute_dtype=jnp.float32)
    jy, jupd = jmod.apply({"params": {"kernel_q": kq, "w_scale": ws, "bias": bias},
                           "quant": {"x_scale": x_scale}}, x, mutable=["quant"])
    tmod = quant.QuantConv(cin, cout, kernel, strides, padding, groups, calibrate=calibrate,
                           compute_dtype=torch.float32)
    tensors = {"kernel_q": torch.from_numpy(hwio_to_oihw(kq)), "w_scale": torch.from_numpy(ws),
               "bias": torch.from_numpy(bias), "x_scale": torch.tensor(x_scale)}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    ty = functional_call(tmod, tensors, (xt,)).permute(0, 2, 3, 1)
    return np.asarray(jy), ty.numpy(), jupd, tmod.updated


@pytest.mark.parametrize("kernel,strides,padding,groups,cin,cout", UNITS, ids=UNIT_IDS)
def test_quant_conv_int8_matches_jax(rng, kernel, strides, padding, groups, cin, cout):
    x, kq, ws, bias, x_scale = unit_operands(rng, kernel, groups, cin, cout, False)
    jy, ty, _, _ = run_both(x, kq, ws, bias, x_scale, kernel, strides, padding, groups, False)
    # the accumulators: the same int8 operands through both convolutions
    xq = np.clip(np.round(x * (np.float32(127.0) / x_scale)), -127, 127).astype(np.int8)
    dn = jax.lax.conv_dimension_numbers(xq.shape, kq.shape, ("NHWC", "HWIO", "NHWC"))
    jacc = jax.lax.conv_general_dilated(xq, kq, strides, padding, dimension_numbers=dn,
                                        feature_group_count=groups,
                                        preferred_element_type=jnp.int32)
    tacc = quant.int8_conv(torch.from_numpy(xq).permute(0, 3, 1, 2),
                           torch.from_numpy(hwio_to_oihw(kq)), strides, padding, groups)
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.permute(0, 2, 3, 1).numpy(), np.asarray(jacc))
    assert jy.shape == ty.shape
    ulps = np.abs(jy - ty) / np.spacing(np.maximum(np.abs(jy), np.float32(1e-30)))
    assert ulps.max() <= 2


@pytest.mark.parametrize("kernel,strides,padding,groups,cin,cout", UNITS[:3] + UNITS[5:],
                         ids=UNIT_IDS[:3] + UNIT_IDS[5:])
def test_quant_conv_calibrate_matches_jax(rng, kernel, strides, padding, groups, cin, cout):
    x, kq, ws, bias, x_scale = unit_operands(rng, kernel, groups, cin, cout, True)
    jy, ty, jupd, tupd = run_both(x, kq, ws, bias, x_scale, kernel, strides, padding, groups,
                                  True)
    assert float(tupd) == float(jupd["quant"]["x_scale"]) == float(np.abs(x).max())
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-6)


def int64_conv(xq, kq_oihw, strides, padding, groups):
    """The reference: NCHW int8 in, int64 sums, TF SAME or VALID, loops over
    the kernel's taps in numpy."""
    from multibox_tpu_torch.models.inception_v3 import same_padding

    x = xq.astype(np.int64)
    O, Cg, kh, kw = kq_oihw.shape
    if padding == "SAME":
        (t, b), (l, r) = (same_padding(x.shape[2], kh, strides[0]),
                          same_padding(x.shape[3], kw, strides[1]))
        x = np.pad(x, ((0, 0), (0, 0), (t, b), (l, r)))
    Ho = (x.shape[2] - kh) // strides[0] + 1
    Wo = (x.shape[3] - kw) // strides[1] + 1
    out = np.zeros((x.shape[0], O, Ho, Wo), np.int64)
    w = kq_oihw.astype(np.int64)
    per = O // groups
    for g in range(groups):
        xs = x[:, g * Cg:(g + 1) * Cg]
        for i in range(kh):
            for j in range(kw):
                tap = xs[:, :, i:i + strides[0] * (Ho - 1) + 1:strides[0],
                         j:j + strides[1] * (Wo - 1) + 1:strides[1]]
                out[:, g * per:(g + 1) * per] += np.einsum(
                    "bchw,oc->bohw", tap, w[g * per:(g + 1) * per, :, i, j])
    return out


@pytest.mark.parametrize("kernel,strides,padding,groups,cin,cout", UNITS, ids=UNIT_IDS)
def test_int8_conv_routes_are_exact_against_int64(rng, kernel, strides, padding, groups, cin,
                                                  cout):
    """Extreme operands (±127 everywhere a sign allows) so that every sum is
    as large as the unit can make it. The plain version (float64), and the
    card's routes' arithmetic on the CPU: ``torch._int_mm`` over the
    gathered columns with K, N and M padded, and the float32 grouped
    convolution."""
    xq = rng.choice(np.array([-127, 127, 0, 1], np.int8), (2, cin, 9, 9))
    kq = rng.choice(np.array([-127, 127], np.int8), (cout, cin // groups) + kernel)
    want = int64_conv(xq, kq, strides, padding, groups)
    xt = torch.from_numpy(xq).contiguous(memory_format=torch.channels_last)
    kt = torch.from_numpy(kq)
    got = quant.int8_conv(xt, kt, strides, padding, groups)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    route = quant.int8_conv_route(kernel, strides, groups, cin)
    if route == "grouped_f32":
        card = quant._conv_exact_float(xt, kt, strides, padding, groups, torch.float32)
    else:
        assert route == ("int_mm_1x1" if kernel == (1, 1) else "int_mm_columns")
        card = quant.int8_conv_columns(xt, kt, strides, padding)
    assert card.dtype == torch.int32
    np.testing.assert_array_equal(card.numpy().astype(np.int64), want)


def test_int8_conv_route_refuses_a_grouped_sum_past_float32():
    assert quant.int8_conv_route((3, 3), (1, 1), 192, 192) == "grouped_f32"
    with pytest.raises(ValueError, match="float32"):
        quant.int8_conv_route((3, 3), (1, 1), 2, 256)  # 9 · 128 · 127² ≥ 2**24


def test_units_take_the_int8_variant_only_when_folded():
    unit = ConvBN(8, 16, (1, 1), folded=True, use_pallas=True, quantize="int8")
    assert isinstance(unit.Conv, quant.QuantConv) and not unit.fused
    assert isinstance(ConvBNRelu6(8, 8, groups=8, folded=True, quantize="calib").Conv,
                      quant.QuantConv)
    with pytest.raises(ValueError, match="folded"):
        ConvBN(8, 16, (3, 3), quantize="int8")
    with pytest.raises(ValueError, match="quantize mode"):
        ConvBNRelu6(8, 8, folded=True, quantize="int4")


def spread(jvars, rng, head="MultiBoxHead"):
    """Random-init confidences sit near 0.5: spread the head's biases (as
    tests/test_torch_cli.py does) so the detections order."""
    tree = jax.tree_util.tree_map(np.array, jvars)
    h = tree["params"][head]
    h["Confidences"]["bias"] = rng.normal(0, 1.0, h["Confidences"]["bias"].shape
                                          ).astype(np.float32)
    h["Locations"]["bias"] = rng.normal(0, 0.05, h["Locations"]["bias"].shape
                                        ).astype(np.float32)
    return tree


BACKBONES = {"inception_v3": {}, "mobilenet_v2": {"mobilenet_width": 0.5}}


@pytest.fixture(scope="module", params=list(BACKBONES))
def prepared(request):
    """Both packages' int8 preparation of the same variables on the same
    calibration batches (tiny Inception: 94 units; MobileNetV2 0.5)."""
    rng = np.random.default_rng(0)
    kw = dict(num_priors=16, input_size=75, compute_dtype="float32", max_detections=10,
              batch_size=2, quantize="int8", backbone=request.param, **BACKBONES[request.param])
    jmodel = jbuild_model(JConfig(**{**kw, "quantize": "none"}), 16)
    jvars = spread(dict(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                             jnp.zeros((2, 75, 75, 3)))), rng)
    calib = [rng.integers(0, 255, (2, 75, 75, 3)).astype(np.uint8) for _ in range(2)]
    jq = jax.tree_util.tree_map(np.asarray, jprepare(JConfig(**kw), jvars, calib))
    tq = prepare_quantized_variables(Config(**kw), convert.flax_to_torch(jvars, device="cpu"),
                                     calib, device="cpu")
    priors = np.sort(rng.uniform(0, 1, (16, 2, 2)).astype(np.float32), axis=1).reshape(16, 4)
    images = rng.integers(0, 255, (2, 75, 75, 3)).astype(np.uint8)
    return {"kw": kw, "jq": jq, "tq": tq, "priors": priors, "images": images,
            "backbone": request.param}


def test_prepared_variables_match_jax(prepared):
    jq, tq = convert.flax_to_torch(prepared["jq"], device="cpu"), prepared["tq"]
    want_units = 94 if prepared["backbone"] == "inception_v3" else 52
    assert len(tq["quant"]) == len(jq["quant"]) == want_units
    assert sorted(tq["params"]) == sorted(jq["params"])
    for key, value in tq["params"].items():
        assert value.dtype == jq["params"][key].dtype, key
        assert torch.equal(value, jq["params"][key]), key
    names = list(tq["quant"])  # forward order
    assert float(tq["quant"][names[0]]) == float(jq["quant"][names[0]])
    for name in names:
        got, want = float(tq["quant"][name]), float(jq["quant"][name])
        assert want > 0 and abs(got - want) <= 5e-6 * want, name


def detect_both(prepared, tq):
    cfg = Config(**prepared["kw"])
    jdet = jax.jit(jmake_detect_body(JConfig(**prepared["kw"]), jnp.asarray(prepared["priors"])))(
        prepared["jq"], jpreprocess(jnp.asarray(prepared["images"]), 75))
    tdet = make_detect_body(cfg, prepared["priors"], device="cpu")(
        tq, preprocess_eval(torch.from_numpy(prepared["images"]), 75))
    return jdet, tdet


@pytest.mark.parametrize("variables", ["jax_prepared", "own"])
def test_int8_detect_matches_jax(prepared, variables):
    tq = (convert.flax_to_torch(prepared["jq"], device="cpu") if variables == "jax_prepared"
          else prepared["tq"])
    atol = 5e-4 if variables == "jax_prepared" else 2e-3
    jdet, tdet = detect_both(prepared, tq)
    np.testing.assert_array_equal(tdet["classes"].numpy(), np.asarray(jdet["classes"]))
    np.testing.assert_array_equal(tdet["num"].numpy(), np.asarray(jdet["num"]))
    np.testing.assert_allclose(tdet["scores"].numpy(), np.asarray(jdet["scores"]), atol=atol)
    np.testing.assert_allclose(tdet["boxes"].numpy(), np.asarray(jdet["boxes"]), atol=atol)
    assert int(tdet["num"].min()) > 0


def test_prepare_needs_a_batch_and_takes_the_first_of_a_dataset(prepared):
    cfg = Config(**prepared["kw"])
    with pytest.raises(ValueError, match="at least one image batch"):
        prepare_quantized_variables(cfg, {"params": {}}, [], device="cpu")
    batches = [{"images": np.full((2, 4, 4, 3), i, np.uint8)} for i in range(5)]
    got = calib_batches_from_dataset(batches, 3)
    assert [int(b[0, 0, 0, 0]) for b in got] == [0, 1, 2]
    model = build_model(dataclasses.replace(cfg, quantize="none"), 16, folded=True,
                        quantize="int8", device="cpu")
    assert sum(isinstance(m, quant.QuantConv) for m in model.modules()) == len(prepared["tq"]
                                                                                 ["quant"])
