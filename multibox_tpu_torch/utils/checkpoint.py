"""Checkpointing with ``torch.save``: periodic saves and resume-by-default.

One file per step, ``<directory>/ckpt_<step>.pt``, holding the whole train
state (step, params, batch_stats, optimizer state with its schedule count,
and the EMA shadows), copied to the host. A save writes to a temporary name
and renames it into place, so a run killed in the middle of a save never
leaves half a checkpoint behind: the latest complete step is what resume
finds. The oldest files beyond ``keep`` are deleted.

Same surface as the JAX package's orbax-based manager: ``save``,
``restore``, ``restore_raw``, ``latest_step``, ``wait``, ``close``. Saves
are synchronous, so ``wait`` has nothing to wait for.

Under a process group (``parallel``) every rank calls ``save`` with the
same state; rank 0 writes and the others wait at a barrier, so that when
``save`` returns the file is complete for every rank. ``save`` decides
from :attr:`CheckpointManager.latest_known_step` (the directory's latest
when the manager was made, then its own saves), never from the directory,
which rank 0 may be writing while another rank decides: every rank must
decide alike, or one waits at a save's barrier the others skip. So the
ranks make their managers between two barriers, with no save in between
(``train_from_batches`` does): every rank reads the directory when no rank
is writing it.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.parallel import mesh
from multibox_tpu_torch.parallel.sync import coordination_barrier

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _to_device(tree, device, grad_like=None):
    if isinstance(tree, dict):
        like = grad_like if isinstance(grad_like, dict) else {}
        return {k: _to_device(v, device, like.get(k)) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.to(device)
        if isinstance(grad_like, torch.Tensor) and grad_like.requires_grad:
            t.requires_grad_(True)
        return t
    return tree


class CheckpointManager:
    """Periodic saves of a train state (``TrainState`` or a dict of its
    fields) and restore of the latest one."""

    def __init__(self, directory: str, keep: int = 3, save_every: int = 1000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.save_every = save_every
        self._latest = self.latest_step()

    @property
    def latest_known_step(self) -> Optional[int]:
        """The latest step in the directory when the manager was made, or
        saved by it since: what ``save`` decides from. Unlike
        :meth:`latest_step` it reads no file, so every rank of a group
        holds the same value."""
        return self._latest

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _NAME.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save at ``step`` when ``force``, or when ``step`` is a multiple
        of ``save_every`` beyond :attr:`latest_known_step`. Returns whether
        it saved."""
        latest = self._latest
        if not force:
            if latest is not None and latest >= step:
                return False
            if self.save_every <= 0 or step % self.save_every:
                return False
        self._latest = step if latest is None else max(latest, step)
        if mesh.rank() == 0:
            tree = state.to_dict() if hasattr(state, "to_dict") else dict(state)
            tree = _to_host(tree)
            path = self._path(step)
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(tree, tmp)
            os.replace(tmp, path)  # atomic: a reader sees all of it or none
            for old in self.all_steps()[:-self.keep] if self.keep > 0 else []:
                os.remove(self._path(old))
        coordination_barrier("checkpoint/save")
        return True

    def restore_raw(self, step: Optional[int] = None, device=None) -> Dict:
        """The saved dictionary (step, params, batch_stats, opt_state,
        ema_params) on ``device`` (``None`` = CUDA), without a template."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        device = resolve_device(device)
        tree = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return _to_device(tree, device)

    def restore(self, state_template: Any, step: Optional[int] = None, device=None):
        """Restore into the structure of ``state_template`` (a
        ``TrainState``): same keys, tensors on ``device`` (``None`` = CUDA),
        parameters requiring grad where the template's do."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        device = resolve_device(device)
        tree = torch.load(self._path(step), map_location="cpu", weights_only=True)
        template = state_template.to_dict()
        for key in ("params", "batch_stats", "ema_params"):
            if set(tree[key]) != set(template[key]):
                raise ValueError(f"checkpoint {key} do not match the state: "
                                 f"{sorted(set(tree[key]) ^ set(template[key]))[:5]}")
        restored = _to_device(tree, device, template)
        return type(state_template)(**restored)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing is held open."""
