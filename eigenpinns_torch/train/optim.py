"""Adam stacks as optax builds them.

Port of `eigenpinns_tpu/train/optim.py`:

  * `adam_exp_decay`: `optax.adam` on `optax.exponential_decay(lr_start,
    steps, lr_end / lr_start)`, lr(t) = lr_start (lr_end/lr_start)^(t /
    steps) in fp32, with t the number of updates made before (the first
    update uses lr_start);
  * `AdamPlateau` (`adam_plateau`): optax `clip_by_global_norm` ->
    `add_decayed_weights` -> `adam`, then the updates times the
    `optax.contrib.reduce_on_plateau` scale.

Both share one Adam core, `Adam`. `AdamPlateau` reproduces optax's
arithmetic step for step:

  1. clip: g <- (g / |g|) * max only when |g| >= max (not torch's
     `clip_grad_norm_`, which adds 1e-6 to the norm);
  2. g <- g + wd * p;
  3. Adam: mu, nu moments, bias correction, -lr * mu_hat /
     (sqrt(nu_hat) + eps), eps = 1e-8 outside the square root;
  4. reduce_on_plateau (accumulation 1, cooldown 0, as adam_plateau
     sets it): improved when loss < (1 - 1e-4) * best; after `patience`
     steps without improvement the scale is multiplied by `factor`,
     floored at `min_scale`. Not torch's `ReduceLROnPlateau`.

All state stays on the parameters' device; `step` never reads a value
back to the host. (`adamw_cosine_restarts` is not ported.)

Layer freezing (`freeze_mask`, `adam_frozen`) is the port of
`optax.multi_transform({"train": optax.adam(lr), "frozen":
optax.set_to_zero()}, _freeze_mask(params, n))` of
`eigenpinns_tpu/solvers/transfer.py`: the Adam core over the trained
parameters only, so a frozen one gets no update and keeps no moments.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam defaults
RTOL = 1e-4                      # optax reduce_on_plateau default


class Adam:
    """`optax.adam(schedule)`: the parameters' `.grad` in, an update of
    -schedule(t) * mu_hat / (sqrt(nu_hat) + eps) applied in place, t the
    number of updates made before."""

    def __init__(self, params, schedule: Callable[[int], float]):
        self.params = list(params)
        self.schedule = schedule
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        """Apply one update from the parameters' `.grad`."""
        torch._foreach_add_(self.params,
                            self._adam_update([p.grad for p in self.params]))

    def _adam_update(self, g: list) -> list:
        lr = self.schedule(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(g, g), alpha=1.0 - B2)
        mu_hat = torch._foreach_div(self.mu, self._bias_correction(B1))
        nu_hat = torch._foreach_div(self.nu, self._bias_correction(B2))
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(upd, -lr)
        return upd

    def _bias_correction(self, decay: float) -> float:
        """1 - decay**count as optax computes it, in fp32: at small
        counts the subtraction cancels, and a float64 value differs from
        the fp32 one by up to 2e-5 relative, a bias that Adam's
        normalized steps carry into every parameter."""
        return float(np.float32(1.0) - np.float32(decay**self.count))


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Callable[[int], float]:
    """`optax.exponential_decay(init_value, transition_steps, decay_rate)`
    in its fp32 arithmetic: init * rate^(t / steps), constant when
    transition_steps <= 0 or decay_rate == 0."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda t: float(np.float32(init_value))

    def schedule(t: int) -> float:
        if t <= 0:
            return float(np.float32(init_value))
        p = np.float32(t) / np.float32(transition_steps)
        return float(np.float32(init_value)
                     * np.power(np.float32(decay_rate), p))

    return schedule


def freeze_mask(named_params, n_frozen: int) -> dict[str, str]:
    """'frozen' or 'train' for each (name, parameter): 'frozen' for the
    first `n_frozen` hidden layers, whose names hold `hidden_<i>` (flax
    and `LambdaEigenNet`) or `hidden.<i>` (the torch `MLP`) with
    i < n_frozen, as the JAX package's `_freeze_mask` labels them."""
    labels = {}
    for name, _ in named_params:
        parts = name.split(".")
        label = "train"
        for j, part in enumerate(parts):
            if part.startswith("hidden_"):
                idx = int(part.split("_")[1])
            elif part == "hidden" and j + 1 < len(parts):
                idx = int(parts[j + 1])
            else:
                continue
            label = "frozen" if idx < n_frozen else "train"
            break
        labels[name] = label
    return labels


def adam_frozen(named_params, learning_rate: float,
                n_frozen: int = 0) -> "Adam":
    """`optax.adam(learning_rate)` on the parameters that `freeze_mask`
    labels 'train'; the frozen ones are left out of the optimizer."""
    named_params = list(named_params)
    labels = freeze_mask(named_params, n_frozen)
    return Adam([p for name, p in named_params if labels[name] == "train"],
                lambda t: learning_rate)


def adam_exp_decay(params, lr_start: float = 1e-2, lr_end: float = 1e-4,
                   steps: int = 20000):
    """Adam with exponential LR decay (simplified_loss.ipynb stack);
    returns (optimizer, schedule) like the JAX function."""
    schedule = exponential_decay(lr_start, steps, lr_end / lr_start)
    return Adam(params, schedule), schedule


class AdamPlateau(Adam):
    def __init__(self, params, learning_rate: float,
                 weight_decay: float = 0.0, grad_clip: float = 0.0,
                 plateau_factor: float = 0.5, plateau_patience: int = 2000,
                 min_scale: float = 1e-3):
        super().__init__(params, lambda t: learning_rate)
        self.wd, self.clip = weight_decay, grad_clip
        self.factor, self.patience = plateau_factor, plateau_patience
        self.min_scale = min_scale
        dev = self.params[0].device
        self.scale = torch.ones((), device=dev)
        self.best = torch.full((), float("inf"), device=dev)
        self.plateau_count = torch.zeros((), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def step(self, value: torch.Tensor) -> None:
        """Apply one update from the parameters' `.grad` and the loss
        `value` (a 0-dim tensor) that produced them."""
        g = [p.grad for p in self.params]
        if self.clip > 0:
            norm = torch.sqrt(sum((x * x).sum() for x in g))
            keep = norm < self.clip
            g = [torch.where(keep, x, (x / norm) * self.clip) for x in g]
        if self.wd:
            g = torch._foreach_add(g, self.params, alpha=self.wd)
        upd = self._adam_update(g)
        torch._foreach_mul_(upd, self._plateau_scale(value))
        torch._foreach_add_(self.params, upd)

    def _plateau_scale(self, value: torch.Tensor) -> torch.Tensor:
        value = value.detach().to(self.best.dtype)
        improved = value < (1 - RTOL) * self.best
        self.best = torch.where(improved, value, self.best)
        count = torch.where(improved, torch.zeros_like(self.plateau_count),
                            self.plateau_count + 1)
        hit = count == self.patience
        self.plateau_count = torch.where(hit, torch.zeros_like(count), count)
        self.scale = torch.clamp(
            torch.where(hit, self.scale * self.factor, self.scale),
            min=self.min_scale)
        return self.scale
