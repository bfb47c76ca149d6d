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
    def apply(self, params: Tensors, grads: Tensors, state: Dict) -> None:
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        if self.clip > 0:
            g = clip_by_global_norm(g, self.clip)
        lr = self.schedule(state["count"])
        count = state["count"] + 1
        if self.name == "rmsprop":
            nu = [state["nu"][k] for k in keys]
            # ν ← (1 − ρ)·g² + ρ·ν;  u = g·rsqrt(ν + ε)
            torch._foreach_mul_(nu, self.decay)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                       1 - self.decay))
            scale = torch._foreach_rsqrt(torch._foreach_add(nu, self.eps))
            u = torch._foreach_mul(scale, g)
            torch._foreach_mul_(u, _f32_scalar(-lr))
            u = self._trace(u, [state["trace"][k] for k in keys])
        elif self.name == "momentum":
            u = self._trace(g, [state["trace"][k] for k in keys])
            u = torch._foreach_mul(u, _f32_scalar(-lr))
        elif self.name == "sgd":
            u = torch._foreach_mul(g, _f32_scalar(-lr))
        else:  # adam, optax's defaults b1 = 0.9, b2 = 0.999, eps_root = 0
            b1, b2 = 0.9, 0.999
            mu = [state["mu"][k] for k in keys]
            nu = [state["nu"][k] for k in keys]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
            c1 = float(1 - torch.pow(_f32(b1), _f32(count)))
            c2 = float(1 - torch.pow(_f32(b2), _f32(count)))
            mu_hat = torch._foreach_div(mu, c1)
            den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
            torch._foreach_add_(den, self.adam_eps)
            u = torch._foreach_div(mu_hat, den)
            torch._foreach_mul_(u, _f32_scalar(-lr))
        torch._foreach_add_(p, u)
        state["count"] = count

    def _trace(self, u: List[torch.Tensor], trace: List[torch.Tensor]):
        # t ← u + m·t; the update is the new trace
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, u)
        return trace


def _f32_scalar(x: float) -> float:
    """``x`` rounded to float32, as optax multiplies by an f32 scalar."""
    return float(_f32(x))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """``optax.clip_by_global_norm``: unchanged below ``max_norm``, else
    ``(g / ‖g‖) · max_norm``."""
    norm = torch.sqrt(sum(torch.sum(x * x) for x in grads))
    if bool(norm < max_norm):
        return grads
    return [(x / norm) * max_norm for x in grads]


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


@torch.no_grad()
def ema_update(ema: Tensors, params: Tensors, step: int, decay: float) -> None:
    """slim's ``ExponentialMovingAverage`` with ``num_updates = step``, in
    place: ``ema ← d·ema + (1 − d)·params`` with ``d = min(decay,
    (1 + t)/(10 + t))`` in float32."""
    t = _f32(step)
    d = float(torch.minimum(_f32(decay), (1.0 + t) / (10.0 + t)))
    keys = list(params)
    shadows = [ema[k] for k in keys]
    torch._foreach_mul_(shadows, d)
    torch._foreach_add_(shadows, torch._foreach_mul(
        [params[k].detach() for k in keys], float(1 - _f32(d))))


def _metrics_mean(per_micro: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Microbatch metrics: ``num_*`` are batch sums (summed), the losses are
    means (averaged)."""
    out = {}
    for k in per_micro[0]:
        v = torch.stack([m[k] for m in per_micro])
        out[k] = v.sum(0) if k.startswith("num_") else v.mean(0)
    return out


def make_train_step(cfg: Config, model, priors, device=None):
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
    device = resolve_device(device)
    optimizer = make_optimizer(cfg)
    priors = torch.as_tensor(priors, dtype=torch.float32).to(device)

    def forward(params, batch_stats, images):
        return detector_mod.apply(model, {"params": params, "batch_stats": batch_stats},
                                  images, train=True)

    if cfg.remat:
        plain_forward = forward

        def forward(params, batch_stats, images):
            return torch.utils.checkpoint.checkpoint(
                plain_forward, params, batch_stats, images, use_reentrant=False)

    def loss_and_grads(params, batch_stats, batch):
        (loc, conf), new_stats = forward(params, batch_stats, batch["images"])
        total, metrics = multibox_loss(
            loc, conf, batch["boxes"], batch["num_boxes"], priors,
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

    def grads_accumulated(state: TrainState, batch):
        A = cfg.grad_accum_steps
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
            grads, stats, metrics = loss_and_grads(state.params, stats, micro)
            for k, g in grads.items():
                gsum[k] += g
            per_micro.append(metrics)
        grads = {k: (g / A).to(state.params[k].dtype) for k, g in gsum.items()}
        return grads, stats, _metrics_mean(per_micro)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if cfg.grad_accum_steps > 1:
            grads, new_stats, metrics = grads_accumulated(state, batch)
        else:
            grads, new_stats, metrics = loss_and_grads(
                state.params, state.batch_stats, batch)
        if mesh.reducing():  # the rows' shares summed: the global gradient
            mesh.all_reduce_tensors(list(grads.values()), "gradients")
        optimizer.apply(state.params, grads, state.opt_state)
        ema_update(state.ema_params, state.params, state.step, cfg.moving_average_decay)
        metrics["learning_rate"] = torch.tensor(
            optimizer.schedule(state.step), dtype=torch.float32)
        state.batch_stats = new_stats
        state.step += 1
        return state, metrics

    return train_step
