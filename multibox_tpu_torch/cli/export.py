"""multibox-torch-export — export the detect program for deployment.

Own counterpart of the JAX package's ``multibox-export``. The detect
function (``inference.apply_and_postprocess``, the live path's own tail,
``cfg.flip_tta`` included) with the chosen weights baked in is exported
with ``torch.export`` at static batch sizes, one program per
``--batch_sizes`` entry, and saved with ``torch.export.save``:

- ``detect.pt2`` (the smallest size) and ``detect_b{N}.pt2`` (the others);
  stale siblings of an earlier export are deleted first;
- ``params.npz`` (the frozen weights), ``priors.pkl``, ``config.json``
  (versioned, with the device the programs were traced on) and
  ``detect.graph.txt`` (the printed program of the smallest size).

Weights: the EMA shadows (``use_ema_for_detect``), ``--fold_bn`` (BatchNorm
folded into the convolutions), or ``--quantize int8`` (EMA, fold, per-channel
int8 backbone, activation scales calibrated on ``--calib_tfrecords``).

The programs are traced on the device they will serve on (``--device``,
default CUDA): their constants stay there, and ``serving.load_exported``
refuses another device. The kernels enter the programs as the custom
operators ``multibox_torch::*``, which count their launches when the
programs run.

``--saved_model`` (a TF SavedModel through jax2tf in the JAX package) has no
PyTorch counterpart on either machine and raises (ROADMAP.md, "Not
portable").

  multibox-torch-export --checkpoint_path LOGDIR --priors P.pkl --output_dir OUT \\
      [--batch_sizes 1 32] [--fold_bn | --quantize int8 --calib_tfrecords ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from multibox_tpu_torch import priors as priors_mod
from multibox_tpu_torch import serving
from multibox_tpu_torch.cli.common import (
    add_config_arg,
    add_device_arg,
    expand_tfrecords,
    load_config,
    setup_logging,
)
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.inference import apply_and_postprocess


class FrozenDetector(nn.Module):
    """``images -> apply_and_postprocess(model, variables, images, priors,
    cfg)`` with the variables and the priors held as buffers, so that
    ``torch.export`` saves them as the program's state. The variables'
    names contain dots and slashes, which buffer names may not: they are
    held as ``v0, v1, ...`` and mapped back on each call."""

    def __init__(self, model, variables: Dict[str, Dict[str, torch.Tensor]],
                 priors: torch.Tensor, cfg: Config):
        super().__init__()
        # not a submodule: its parameters are the meta placeholders that
        # the buffers below replace on each call
        self.__dict__["model"] = model
        self.cfg = cfg
        self.names = []  # (collection, variable name, buffer name)
        for collection, tensors in variables.items():
            for name, value in tensors.items():
                buf = f"v{len(self.names)}"
                self.register_buffer(buf, value.detach())
                self.names.append((collection, name, buf))
        self.register_buffer("priors", priors)

    def forward(self, images: torch.Tensor):
        variables: Dict[str, Dict[str, torch.Tensor]] = {}
        for collection, name, buf in self.names:
            variables.setdefault(collection, {})[name] = getattr(self, buf)
        return apply_and_postprocess(self.model, variables, images, self.priors, self.cfg)


def export_detector(cfg: Config, model, variables, priors, output_dir: str,
                    batch_sizes: Sequence[int], device) -> Dict[int, str]:
    """Export ``model`` with ``variables`` (already chosen: EMA, folded or
    int8) at each of ``batch_sizes`` into ``output_dir``, with the
    parameters, priors and config beside them. Returns ``{size: path}``."""
    device = resolve_device(device)
    priors_t = torch.as_tensor(np.asarray(priors, np.float32)).to(device)
    frozen = FrozenDetector(model, variables, priors_t, cfg)
    os.makedirs(output_dir, exist_ok=True)
    # a stale sibling would serve an older checkpoint's weights at its size
    for stale in glob.glob(os.path.join(output_dir, serving.SIBLING_GLOB)):
        os.remove(stale)
    sizes = sorted(set(int(b) for b in batch_sizes))
    paths = {}
    for i, bs in enumerate(sizes):
        example = torch.zeros((bs, cfg.input_size, cfg.input_size, 3),
                              dtype=torch.float32, device=device)
        with torch.no_grad():
            program = torch.export.export(frozen, (example,), strict=False)
        name = serving.PROGRAM if i == 0 else f"detect_b{bs}.pt2"
        paths[bs] = os.path.join(output_dir, name)
        torch.export.save(program, paths[bs])
        if i == 0:
            with open(os.path.join(output_dir, "detect.graph.txt"), "w") as f:
                f.write(str(program))
    np.savez(os.path.join(output_dir, "params.npz"), **{
        f"{collection}/{name}": value.detach().cpu().numpy()
        for collection, tensors in variables.items() for name, value in tensors.items()})
    priors_mod.save_priors(np.asarray(priors, np.float32),
                           os.path.join(output_dir, "priors.pkl"))
    serving.write_config(cfg, os.path.join(output_dir, "config.json"), device)
    return paths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--priors", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--batch_sizes", type=int, nargs="+", default=None,
                        help="export one program per batch size (static "
                             "shapes); serving.load_exported dispatches "
                             "each request to the best-fitting size and "
                             "pads only the remainder")
    parser.add_argument("--saved_model", action="store_true",
                        help="not portable: raises (no TF SavedModel path "
                             "from PyTorch here)")
    parser.add_argument("--fold_bn", action="store_true",
                        help="fold BatchNorm into the convolution weights")
    parser.add_argument("--quantize", choices=["int8"], default=None,
                        help="export the int8 PTQ detect program (folds BN, "
                             "per-channel int8 backbone convolutions); needs "
                             "--calib_tfrecords for activation calibration")
    parser.add_argument("--calib_tfrecords", nargs="+", default=None,
                        help="tfrecords supplying quant_calib_batches "
                             "calibration batches for --quantize")
    add_config_arg(parser)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    setup_logging()
    if args.saved_model:
        raise SystemExit(
            "--saved_model: a TF SavedModel needs jax2tf, which has no PyTorch "
            "counterpart on either machine (ROADMAP.md, 'Not portable'); serve the "
            "torch.export programs with multibox-torch-serve")
    if args.quantize and args.fold_bn:
        raise SystemExit("--quantize already folds BN; drop --fold_bn")
    if args.quantize and not args.calib_tfrecords:
        raise SystemExit("--quantize needs --calib_tfrecords (activation scales are "
                         "calibrated on real data)")
    device = resolve_device(args.device)

    cfg = load_config(args)
    priors = priors_mod.load_priors(args.priors)
    cfg.num_priors = priors.shape[0]

    from multibox_tpu_torch.inference import build_model
    from multibox_tpu_torch.train.state import create_train_state
    from multibox_tpu_torch.utils.checkpoint import CheckpointManager

    model = build_model(cfg, priors.shape[0], device=device)
    state = create_train_state(cfg, model, 0, priors.shape[0], device=device)
    state = CheckpointManager(args.checkpoint_path).restore(state, device=device)
    variables = {
        "params": state.ema_params if cfg.use_ema_for_detect else state.params,
        "batch_stats": state.batch_stats,
    }
    if args.quantize:
        from multibox_tpu_torch.data.pipeline import DetectionDataset
        from multibox_tpu_torch.quantize import (
            calib_batches_from_dataset,
            prepare_quantized_variables,
        )

        cfg.quantize = args.quantize
        calib_ds = DetectionDataset(
            expand_tfrecords(args.calib_tfrecords),
            batch_size=cfg.batch_size,
            canvas_size=cfg.input_size,
            max_num_bboxes=cfg.max_num_bboxes,
        )
        variables = prepare_quantized_variables(
            cfg, dict(variables, ema=state.ema_params),
            calib_batches_from_dataset(calib_ds, cfg.quant_calib_batches), device=device)
        model = build_model(cfg, priors.shape[0], folded=True, quantize="int8",
                            device=device)
    elif args.fold_bn:
        from multibox_tpu_torch.models.inception_v3 import fold_batch_norms

        variables = fold_batch_norms(variables)
        model = build_model(cfg, priors.shape[0], folded=True, device=device)
    export_detector(cfg, model, variables, priors, args.output_dir,
                    args.batch_sizes or [args.batch_size], device)
    print(f"exported to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
