"""Train state, learning-rate schedules, optimizers and the train step.

Optimizer semantics are optax's, as the JAX package uses them, written
here on plain tensors:

- RMSProp is ``scale_by_rms`` (ν ← (1 − ρ)·g² + ρ·ν, u = g·rsqrt(ν + ε):
  ε INSIDE the square root, ν starting at 0) → ``scale_by_learning_rate``
  → ``trace(momentum)``. ``torch.optim.RMSprop`` puts ε outside the root;
  at the default ε = 1.0 the first step differs by 38 %, so it is not used.
- momentum / sgd are ``trace`` → ``scale_by_learning_rate``; adam is
  ``scale_by_adam`` (bias-corrected, ε outside the root) →
  ``scale_by_learning_rate``.
- ``clip_by_global_norm`` runs before the update when
  ``cfg.clip_gradient_norm > 0``.
- The optimizer state keeps the schedule's own step count, so a resumed
  run continues on the same learning rate.

Per-parameter updates are batched with ``torch._foreach_*`` so that an
update costs a few launches per family of operations, not a few per
parameter.

The parameters EMA follows slim's ``ExponentialMovingAverage`` with
``num_updates``: decay ``min(decay, (1 + t)/(10 + t))`` at the step t
before the increment. A train step updates the state's tensors in place
and returns the state.

The values that change from step to step (the learning rate, Adam's bias
corrections, the EMA decay) are computed on the host in float32, as
before, and staged to the device as one small float32 tensor a step
(``TrainStep.host_scalars``, :func:`stage_scalars`); the device part of the
step (``TrainStep.device_step``) takes them as 0-d tensors and reads no
host value, so that a CUDA graph can replay it (``multibox_tpu_torch.graphs``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from multibox_tpu_torch.config import Config
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.models import detector as detector_mod
from multibox_tpu_torch.parallel import mesh
from multibox_tpu_torch.train.loss import multibox_loss

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tensors
    batch_stats: Tensors
    opt_state: Dict
    ema_params: Tensors  # EMA shadows of params (used at inference)

    def detect_variables(self) -> Dict[str, Tensors]:
        """Variables for ``inference.make_detect_fn`` (with the EMA
        collection)."""
        return {"params": self.params, "batch_stats": self.batch_stats,
                "ema": self.ema_params}

    def clone(self) -> "TrainState":
        """A deep copy (the train step updates tensors in place)."""
        def copy(tree):
            if isinstance(tree, dict):
                return {k: copy(v) for k, v in tree.items()}
            if isinstance(tree, torch.Tensor):
                return tree.detach().clone().requires_grad_(tree.requires_grad)
            return tree
        return TrainState(self.step, copy(self.params), copy(self.batch_stats),
                          copy(self.opt_state), copy(self.ema_params))

    def to_dict(self) -> Dict:
        return {"step": self.step, "params": self.params,
                "batch_stats": self.batch_stats, "opt_state": self.opt_state,
                "ema_params": self.ema_params}


# ---------------------------------------------------------------------------
# learning-rate schedules (optax's, in float32 as they run there)
# ---------------------------------------------------------------------------

def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      staircase: bool = False,
                      end_value: Optional[float] = None) -> Callable[[int], float]:
    """``optax.exponential_decay`` (``transition_begin`` 0). As there, a
    zero rate or a non-positive ``transition_steps`` gives the constant
    ``init_value``."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: float(_f32(init_value))

    def schedule(count: int) -> float:
        p = _f32(count) / _f32(transition_steps)
        if staircase:
            p = torch.floor(p)
        value = _f32(init_value) if count <= 0 else \
            _f32(init_value) * torch.pow(_f32(decay_rate), p)
        if end_value is not None:
            clip = torch.maximum if decay_rate < 1.0 else torch.minimum
            value = clip(value, _f32(end_value))
        return float(value)
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = torch.minimum(_f32(count), _f32(decay_steps))
        cosine = 0.5 * (1 + torch.cos(_f32(math.pi) * c / _f32(decay_steps)))
        decayed = (1 - _f32(alpha)) * cosine + _f32(alpha)
        return float(_f32(init_value) * decayed)
    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule`` (``transition_begin`` 0); constant
    ``init_value`` for a non-positive ``transition_steps``, as there."""
    if transition_steps <= 0:
        return lambda count: float(_f32(init_value))

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        frac = 1 - _f32(c) / _f32(transition_steps)
        return float((_f32(init_value) - _f32(end_value)) * frac + _f32(end_value))
    return schedule


def join_schedules(schedules, boundaries) -> Callable[[int], float]:
    """``optax.join_schedules``: from each boundary on, the next schedule
    counted from that boundary."""
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, s in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = s(step - boundary)
        return out
    return schedule


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """Staircase exponential decay (slim) or cosine, with an optional floor
    (``cfg.min_learning_rate``) and linear warmup (``cfg.warmup_steps``)."""
    if cfg.lr_schedule == "cosine":
        sched = cosine_decay_schedule(
            cfg.initial_learning_rate,
            max(cfg.max_number_of_steps - cfg.warmup_steps, 1),
            alpha=(cfg.min_learning_rate / cfg.initial_learning_rate
                   if cfg.initial_learning_rate else 0.0))
    elif cfg.lr_schedule == "exponential":
        decay_steps = max(
            int(cfg.num_epochs_per_decay * cfg.num_train_examples / cfg.batch_size), 1)
        sched = exponential_decay(
            cfg.initial_learning_rate, decay_steps, cfg.learning_rate_decay_factor,
            staircase=True, end_value=cfg.min_learning_rate or None)
    else:
        raise ValueError(f"unknown lr_schedule: {cfg.lr_schedule!r}")
    if cfg.warmup_steps > 0:
        warmup = linear_schedule(0.0, cfg.initial_learning_rate, cfg.warmup_steps)
        sched = join_schedules([warmup, sched], [cfg.warmup_steps])
    return sched


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _zeros(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(v, memory_format=torch.preserve_format).detach()
            for k, v in params.items()}


class Optimizer:
    """One optax-semantics optimizer family over a flat dict of parameters.

    ``init(params)`` → state; ``apply(params, grads, state)`` updates
    ``params`` and ``state`` in place. ``grads`` is a dict keyed like
    ``params``."""

    def __init__(self, cfg: Config):
        self.name = cfg.optimizer.lower()
        if self.name not in ("rmsprop", "momentum", "sgd", "adam"):
            raise ValueError(f"unknown optimizer: {cfg.optimizer!r}")
        self.schedule = make_lr_schedule(cfg)
        self.decay = cfg.rmsprop_decay
        self.eps = cfg.rmsprop_epsilon
        self.momentum = cfg.rmsprop_momentum
        self.adam_eps = cfg.adam_epsilon
        self.clip = cfg.clip_gradient_norm

    def scalars(self, count: int) -> List[float]:
        """The host values of the update at the schedule's ``count``:
        ``[-lr, c1, c2]`` as float32 values (Adam's bias corrections
        ``1 − b^(count + 1)``; 1 for the other families)."""
        lr = self.schedule(count)
        c1 = c2 = 1.0
        if self.name == "adam":
            c1 = float(1 - torch.pow(_f32(_ADAM_B1), _f32(count + 1)))
            c2 = float(1 - torch.pow(_f32(_ADAM_B2), _f32(count + 1)))
        return [_f32_scalar(-lr), c1, c2]

    def init(self, params: Tensors) -> Dict:
        state: Dict = {"count": 0}
        if self.name == "rmsprop":
            state["nu"] = _zeros(params)
            state["trace"] = _zeros(params)
        elif self.name == "momentum":
            state["trace"] = _zeros(params)
        elif self.name == "adam":
            state["mu"] = _zeros(params)
            state["nu"] = _zeros(params)
        return state

    @torch.no_grad()
    def apply(self, params: Tensors, grads: Tensors, state: Dict,
              scalars: Optional[torch.Tensor] = None) -> None:
        """One update in place; ``state["count"]`` advances on the host.
        ``scalars``: this step's values staged on the parameters' device
        (:func:`stage_scalars` of :meth:`scalars`); made here when not
        given."""
        if scalars is None:
            scalars = stage_scalars(self.scalars(state["count"]),
                                    next(iter(params.values())).device)
        self.apply_staged(params, grads, state, scalars)
        state["count"] += 1

    @torch.no_grad()
    def apply_staged(self, params: Tensors, grads: Tensors, state: Dict,
                     scalars: torch.Tensor) -> None:
        """The device part of :meth:`apply`: ``scalars[0..2]`` are
        ``-lr``, ``c1``, ``c2`` (0-d tensors); no host value is read and
        the host count is left alone."""
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        if self.clip > 0:
            g = clip_by_global_norm(g, self.clip)
        neg_lr = scalars[_NEG_LR]
        if self.name == "rmsprop":
            nu = [state["nu"][k] for k in keys]
            # ν ← (1 − ρ)·g² + ρ·ν;  u = g·rsqrt(ν + ε)
            torch._foreach_mul_(nu, self.decay)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                       1 - self.decay))
            scale = torch._foreach_rsqrt(torch._foreach_add(nu, self.eps))
            u = torch._foreach_mul(scale, g)
            torch._foreach_mul_(u, neg_lr)
            u = self._trace(u, [state["trace"][k] for k in keys])
        elif self.name == "momentum":
            u = self._trace(g, [state["trace"][k] for k in keys])
            u = torch._foreach_mul(u, neg_lr)
        elif self.name == "sgd":
            u = torch._foreach_mul(g, neg_lr)
        else:  # adam, optax's defaults b1 = 0.9, b2 = 0.999, eps_root = 0
            b1, b2 = _ADAM_B1, _ADAM_B2
            mu = [state["mu"][k] for k in keys]
            nu = [state["nu"][k] for k in keys]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
            mu_hat = torch._foreach_div(mu, scalars[_C1])
            den = torch._foreach_sqrt(torch._foreach_div(nu, scalars[_C2]))
            torch._foreach_add_(den, self.adam_eps)
            u = torch._foreach_div(mu_hat, den)
            torch._foreach_mul_(u, neg_lr)
        torch._foreach_add_(p, u)

    def _trace(self, u: List[torch.Tensor], trace: List[torch.Tensor]):
        # t ← u + m·t; the update is the new trace
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, u)
        return trace


def _f32_scalar(x: float) -> float:
    """``x`` rounded to float32, as optax multiplies by an f32 scalar."""
    return float(_f32(x))


_ADAM_B1, _ADAM_B2 = 0.9, 0.999
# a step's staged values (TrainStep.host_scalars): the optimizer's, then the EMA's
_NEG_LR, _C1, _C2, _EMA_D, _EMA_1MD = range(5)
NUM_SCALARS = 5


def stage_scalars(values: List[float], device) -> torch.Tensor:
    """``values`` as a float32 tensor on ``device``; to a CUDA device
    through pinned memory without waiting for the copy."""
    host = torch.tensor(values, dtype=torch.float32)
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """``optax.clip_by_global_norm``: unchanged below ``max_norm``, else
    ``(g / ‖g‖) · max_norm``. The choice is made on the device, with no
    wait for the norm: each gradient becomes ``(g / d) · m`` with ``(d, m)``
    ``(1, 1)`` below the bound, which leaves it exactly as it was, and
    ``(‖g‖, max_norm)`` above it, the clipped value itself."""
    norm = torch.sqrt(sum(torch.sum(x * x) for x in grads))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    den = torch.where(keep, one, norm)
    mul = torch.where(keep, one, torch.full_like(norm, max_norm))
    out = torch._foreach_div(grads, den)
    torch._foreach_mul_(out, mul)
    return out


def make_optimizer(cfg: Config) -> Optimizer:
    """The optimizer ``cfg.optimizer`` names (rmsprop, momentum, sgd, adam),
    with gradient clipping when ``cfg.clip_gradient_norm > 0``."""
    return Optimizer(cfg)


# ---------------------------------------------------------------------------
# state and step
# ---------------------------------------------------------------------------

def create_train_state(cfg: Config, model, rng, num_priors: int, device=None,
                       variables: Optional[Dict[str, Tensors]] = None) -> TrainState:
    """Initialize params, optimizer state and EMA on ``device`` (``None`` =
    CUDA, raises without one). ``model`` from ``inference.build_model``.
    ``rng`` is an int seed or a ``torch.Generator`` for
    ``MultiBoxDetector.init_variables``; ``variables`` (e.g. converted
    from the JAX package with ``models.convert.flax_to_torch``) replaces
    the random initialization."""
    device = resolve_device(device)
    if model.num_priors != num_priors:
        raise ValueError(f"model has {model.num_priors} priors, not {num_priors}")
    if variables is None:
        gen = rng if isinstance(rng, torch.Generator) else \
            torch.Generator().manual_seed(int(rng))
        variables = model.init_variables(gen)
    params = {k: v.detach().to(device, torch.float32).clone().requires_grad_(True)
              for k, v in variables["params"].items()}
    stats = {k: v.detach().to(device).clone()
             for k, v in variables.get("batch_stats", {}).items()}
    ema = {k: v.detach().clone() for k, v in params.items()}
    return TrainState(step=0, params=params, batch_stats=stats,
                      opt_state=make_optimizer(cfg).init(params), ema_params=ema)


def ema_scalars(step: int, decay: float) -> List[float]:
    """The host values of the EMA update at ``step``: ``[d, 1 − d]`` with
    ``d = min(decay, (1 + t)/(10 + t))``, in float32."""
    t = _f32(step)
    d = float(torch.minimum(_f32(decay), (1.0 + t) / (10.0 + t)))
    return [d, float(1 - _f32(d))]


@torch.no_grad()
def ema_update(ema: Tensors, params: Tensors, step: int, decay: float,
               scalars: Optional[torch.Tensor] = None) -> None:
    """slim's ``ExponentialMovingAverage`` with ``num_updates = step``, in
    place: ``ema ← d·ema + (1 − d)·params`` with ``d = min(decay,
    (1 + t)/(10 + t))`` in float32. ``scalars``: ``[d, 1 − d]``
    (:func:`ema_scalars`) staged on the device; made here when not given."""
    if scalars is None:
        scalars = stage_scalars(ema_scalars(step, decay), next(iter(params.values())).device)
    ema_update_staged(ema, params, scalars[0], scalars[1])


@torch.no_grad()
def ema_update_staged(ema: Tensors, params: Tensors, d: torch.Tensor,
                      one_minus_d: torch.Tensor) -> None:
    """The device part of :func:`ema_update`, ``d`` and ``1 − d`` as 0-d
    tensors."""
    keys = list(params)
    shadows = [ema[k] for k in keys]
    torch._foreach_mul_(shadows, d)
    torch._foreach_add_(shadows, torch._foreach_mul(
        [params[k].detach() for k in keys], one_minus_d))


def _metrics_mean(per_micro: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Microbatch metrics: ``num_*`` are batch sums (summed), the losses are
    means (averaged)."""
    out = {}
    for k in per_micro[0]:
        v = torch.stack([m[k] for m in per_micro])
        out[k] = v.sum(0) if k.startswith("num_") else v.mean(0)
    return out


def make_train_step(cfg: Config, model, priors, device=None) -> "TrainStep":
    """Build ``step(state, batch) -> (state, metrics)``. ``batch``:
    ``images [B, S, S, 3]`` float32 in [-1, 1], ``boxes [B, G, 4]``,
    ``num_boxes [B]`` int, optional ``labels [B, G]``, on ``device``.

    The step runs forward (train-mode BatchNorm), the MultiBox loss,
    backward, the optimizer and the EMA update. ``cfg.grad_accum_steps``
    > 1 runs that many sequential microbatches, the BatchNorm statistics
    carried from one to the next and the gradients summed in f32, then one
    update. ``cfg.remat`` recomputes the forward in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations.

    Inside ``parallel.mesh.data_parallel`` under a group (the step of
    ``parallel.make_parallel_train_step``) ``batch`` is the rank's rows of
    the global batch: BatchNorm and the loss reduce over the global batch,
    the microbatches are slices of the global batch, and the gradients are
    summed over the ranks (one collective a dtype) before the optimizer."""
    return TrainStep(cfg, model, priors, device=device)


class TrainStep:
    """The train step of :func:`make_train_step`: calling it runs one step
    eagerly. Its parts, for a caller that replays the device part as a CUDA
    graph (``multibox_tpu_torch.graphs``): :meth:`host_scalars` (the
    step's host values), :meth:`device_step` (everything on the device,
    with those values staged) and :meth:`finish` (the host's bookkeeping)."""

    def __init__(self, cfg: Config, model, priors, device=None):
        self.cfg = cfg
        self.model = model
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(cfg)
        self.priors = torch.as_tensor(priors, dtype=torch.float32).to(self.device)

    def _forward(self, params, batch_stats, images):
        variables = {"params": params, "batch_stats": batch_stats}
        if not self.cfg.remat:
            return detector_mod.apply(self.model, variables, images, train=True)
        # the forward draws no random numbers: no generator state to keep
        # for the recompute (and none to read inside a graph's capture)
        return torch.utils.checkpoint.checkpoint(
            lambda p, s, x: detector_mod.apply(self.model, {"params": p, "batch_stats": s},
                                               x, train=True),
            params, batch_stats, images, use_reentrant=False, preserve_rng_state=False)

    def _loss_and_grads(self, params, batch_stats, batch):
        cfg = self.cfg
        (loc, conf), new_stats = self._forward(params, batch_stats, batch["images"])
        total, metrics = multibox_loss(
            loc, conf, batch["boxes"], batch["num_boxes"], self.priors,
            alpha=cfg.location_loss_alpha,
            matching=cfg.matching,
            hybrid_conf_weight=cfg.hybrid_conf_weight,
            hard_negative_ratio=cfg.hard_negative_ratio,
            multi_match_iou=cfg.multi_match_iou,
            encode=cfg.box_encoding,
            gt_labels=batch.get("labels"),
            use_pallas=cfg.use_pallas,
            conf_loss=cfg.conf_loss,
            focal_gamma=cfg.focal_gamma,
            focal_alpha=cfg.focal_alpha,
        )
        keys = list(params)
        # a parameter off the loss's path (MobileNetV2's Head unit under the
        # SSD head) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(total, [params[k] for k in keys],
                                    allow_unused=True, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(zip(keys, grads)), new_stats, metrics

    def _grads_accumulated(self, state: TrainState, batch):
        A = self.cfg.grad_accum_steps
        local = batch["images"].shape[0]
        # microbatch a is rows [a·B/A, (a+1)·B/A) of the GLOBAL batch (the
        # ranks' rows in rank order); each rank runs its part of it, with
        # zero rows where it holds none, so that every rank issues the same
        # collectives
        first, B = mesh.global_rows(local) or (0, local)
        if B % A != 0:
            raise ValueError(f"batch dim {B} not divisible by grad_accum_steps={A}")
        stats = state.batch_stats
        gsum = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in state.params.items()}
        per_micro = []
        for a in range(A):
            lo, hi = (min(max(r - first, 0), local) for r in (a * (B // A), (a + 1) * (B // A)))
            micro = {k: v[lo:hi] for k, v in batch.items()}
            grads, stats, metrics = self._loss_and_grads(state.params, stats, micro)
            for k, g in grads.items():
                gsum[k] += g
            per_micro.append(metrics)
        grads = {k: (g / A).to(state.params[k].dtype) for k, g in gsum.items()}
        return grads, stats, _metrics_mean(per_micro)

    def host_scalars(self, state: TrainState, ahead: int = 0) -> List[float]:
        """The host values of the step ``ahead`` steps after ``state``'s
        (:data:`NUM_SCALARS` floats: the optimizer's, then the EMA's)."""
        return (self.optimizer.scalars(state.opt_state["count"] + ahead)
                + ema_scalars(state.step + ahead, self.cfg.moving_average_decay))

    def device_step(self, state: TrainState, batch, scalars: torch.Tensor):
        """Forward, loss, backward, the optimizer and the EMA in place, with
        this step's :meth:`host_scalars` staged in ``scalars``; returns
        ``(new_batch_stats, metrics)``. Reads no host value and changes
        nothing on the host."""
        if self.cfg.grad_accum_steps > 1:
            grads, new_stats, metrics = self._grads_accumulated(state, batch)
        else:
            grads, new_stats, metrics = self._loss_and_grads(
                state.params, state.batch_stats, batch)
        if mesh.reducing():  # the rows' shares summed: the global gradient
            mesh.all_reduce_tensors(list(grads.values()), "gradients")
        self.optimizer.apply_staged(state.params, grads, state.opt_state, scalars)
        ema_update_staged(state.ema_params, state.params, scalars[_EMA_D],
                          scalars[_EMA_1MD])
        return new_stats, metrics

    def learning_rate(self, step: int) -> torch.Tensor:
        """The logged ``learning_rate`` of the step at ``step``."""
        return torch.tensor(self.optimizer.schedule(step), dtype=torch.float32)

    def finish(self, state: TrainState, steps: int = 1) -> None:
        """The host's part after ``steps`` device steps: the counts."""
        state.opt_state["count"] += steps
        state.step += steps

    def __call__(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        scalars = stage_scalars(self.host_scalars(state), self.device)
        new_stats, metrics = self.device_step(state, batch, scalars)
        metrics["learning_rate"] = self.learning_rate(state.step)
        state.batch_stats = new_stats
        self.finish(state)
        return state, metrics
