"""Shared CLI plumbing: logging, tfrecord globs, the config file and the
device flag.

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
