"""Shared CLI plumbing: logging, tfrecord globs, the config file, the
device flag and joining a ``torchrun`` process group.

Own counterpart of the JAX package's ``cli/common.py``, without its
compilation cache and platform flags: PyTorch compiles nothing ahead of a
run, and the device is chosen with ``--device``.
"""

from __future__ import annotations

import argparse
import glob
import logging
from typing import List

from multibox_tpu_torch.config import Config, parse_config_file


def setup_logging(verbose: bool = True) -> None:
    logging.basicConfig(
        level=logging.INFO if verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )


def expand_tfrecords(patterns: List[str]) -> List[str]:
    paths: List[str] = []
    for p in patterns:
        matched = sorted(glob.glob(p))
        paths.extend(matched if matched else [p])
    if not paths:
        raise SystemExit("no tfrecord files matched")
    return paths


def add_config_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--config", type=str, default=None,
        help="YAML config (reference UPPER_CASE keys accepted)",
    )


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the CUDA device, and an "
             "error without one; 'cpu' runs on the CPU)",
    )


def load_config(args: argparse.Namespace) -> Config:
    return parse_config_file(args.config) if args.config else Config()


def add_parallel_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--dist_backend", choices=("nccl", "gloo"), default=None,
        help="under torchrun: the process group's backend (default: NCCL, "
             "each rank on cuda:LOCAL_RANK; gloo when --device is cpu; pass "
             "gloo for ranks that share the card --device names)",
    )


def init_parallel(args: argparse.Namespace) -> bool:
    """Join the process group ``torchrun`` describes in the environment,
    if any (``parallel.init_data_parallel``)."""
    from multibox_tpu_torch.parallel import init_data_parallel

    return init_data_parallel(backend=args.dist_backend, device=args.device)
