"""multibox-torch-train — training CLI (the flags of the JAX package's
``multibox-train``, plus ``--device`` and ``--dist_backend``).

Data parallel on N cards:
``torchrun --nproc_per_node N -m multibox_tpu_torch.cli.train ...``; each
rank joins the process group first thing and trains on the global batch
``cfg.batch_size`` (``train.loop.train``). With ``--restart_every_steps``
the supervisor stays one process that joins no group, and each child
joins it."""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys

from multibox_tpu_torch import priors as priors_mod
from multibox_tpu_torch.cli.common import (
    add_config_arg,
    add_device_arg,
    add_parallel_arg,
    expand_tfrecords,
    init_parallel,
    load_config,
    setup_logging,
)
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.utils.checkpoint import CheckpointManager

log = logging.getLogger(__name__)


def _latest_ckpt_step(logdir: str) -> int:
    """Latest committed checkpoint step in ``logdir`` (0 when none). A
    checkpoint file appears by atomic rename, so one that exists is
    complete. Files only: the supervisor never touches the device."""
    if not os.path.isdir(logdir):
        return 0
    return CheckpointManager(logdir).latest_step() or 0


def _strip_flag(argv: list, name: str) -> list:
    """Remove ``name <value>`` / ``name=<value>`` occurrences from argv."""
    out = []
    skip = False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok == name:
            skip = True  # drop the following value token too
            continue
        if tok.startswith(name + "="):
            continue
        out.append(tok)
    return out


def _supervise(argv: list, logdir: str, total: int, restart: int,
               run_child=subprocess.call) -> int:
    """Run training as a chain of bounded-lifetime child processes, each
    covering ≤ ``restart`` steps and resuming from the logdir.

    - crash auto-restart: a child that dies mid-run is relaunched from its
      last checkpoint; progress counts as success whatever the exit code,
      and only three attempts in a row without progress abort the run.
    - bounded worker lifetime: host memory a long run leaks is reclaimed
      at every process boundary.

    Children rerun the original argv (``--device`` included) with only the
    supervisor and step flags replaced. ``run_child`` is injectable for
    tests; the default launches ``python -m multibox_tpu_torch.cli.train``
    in a fresh interpreter.
    """
    base = list(argv)
    for flag in ("--restart_every_steps", "--max_number_of_steps",
                 "--schedule_total_steps"):
        base = _strip_flag(base, flag)
    child = [
        sys.executable, "-m", "multibox_tpu_torch.cli.train",
        *base, "--restart_every_steps", "0",
        # children stop at intermediate boundaries, but the LR schedule
        # anneals over the whole run
        "--schedule_total_steps", str(total),
    ]

    done = _latest_ckpt_step(logdir)
    stalls = 0
    while done < total:
        target = min(done + restart, total)
        log.info("supervisor: child for steps %d -> %d", done, target)
        rc = run_child(child + ["--max_number_of_steps", str(target)])
        now = _latest_ckpt_step(logdir)
        if now > done:
            if rc != 0:
                log.warning(
                    "supervisor: child died (exit %d) after reaching step "
                    "%d; restarting from checkpoint", rc, now,
                )
            done, stalls = now, 0
        else:
            stalls += 1
            log.error(
                "supervisor: child made no progress (exit %d, still at "
                "step %d), attempt %d/3", rc, now, stalls,
            )
            if stalls >= 3:
                return 1
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tfrecords", nargs="+", required=True,
                        help="tfrecord files or globs")
    parser.add_argument("--priors", required=True, help="priors pickle path")
    parser.add_argument("--logdir", required=True,
                        help="checkpoints + metrics (resumes if present)")
    parser.add_argument("--pretrained_model", default=None,
                        help="logdir of an earlier run to warm-start the backbone")
    parser.add_argument("--max_number_of_steps", type=int, default=None)
    parser.add_argument("--eval_tfrecords", nargs="+", default=None,
                        help="validation tfrecords for periodic AP eval")
    parser.add_argument("--eval_every_steps", type=int, default=1000)
    parser.add_argument("--no_mesh", action="store_true",
                        help="under several ranks, train each rank's shard "
                             "with its own one-device step (no gradient "
                             "all-reduce), as the JAX package's flag does")
    parser.add_argument("--restart_every_steps", type=int, default=None,
                        help="supervise bounded-lifetime child processes of N "
                             "steps each (crash auto-restart + host-RAM "
                             "reclaim; overrides cfg.restart_every_steps)")
    parser.add_argument("--schedule_total_steps", type=int, default=None,
                        help="LR-schedule horizon when one logical run spans "
                             "several bounded invocations (the supervisor "
                             "sets this for its children)")
    add_config_arg(parser)
    add_device_arg(parser)
    add_parallel_arg(parser)
    args = parser.parse_args(argv)
    setup_logging()
    cfg = load_config(args)
    restart = (
        args.restart_every_steps
        if args.restart_every_steps is not None
        else cfg.restart_every_steps
    )
    if restart <= 0:  # the supervisor launches the children and joins no group
        init_parallel(args)
    device = resolve_device(args.device)
    if restart > 0:
        total = (
            args.max_number_of_steps
            if args.max_number_of_steps is not None
            else cfg.max_number_of_steps
        )
        return _supervise(
            list(argv) if argv is not None else sys.argv[1:],
            args.logdir, total, restart,
        )
    priors = priors_mod.load_priors(args.priors)
    cfg.num_priors = priors.shape[0]

    from multibox_tpu_torch.train.loop import train

    train(
        cfg,
        expand_tfrecords(args.tfrecords),
        priors,
        args.logdir,
        pretrained_model=args.pretrained_model,
        max_steps=args.max_number_of_steps,
        use_mesh=not args.no_mesh,
        eval_tfrecords=(
            expand_tfrecords(args.eval_tfrecords) if args.eval_tfrecords else None
        ),
        eval_every_steps=args.eval_every_steps,
        schedule_total=args.schedule_total_steps,
        device=device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
