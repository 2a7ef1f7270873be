"""Adam + weight decay + clipping + reduce-on-plateau, as optax chains it.

Port of `eigenpinns_tpu/train/optim.py::adam_plateau`, which chains
optax `clip_by_global_norm` -> `add_decayed_weights` -> `adam` and then
multiplies the updates by the `optax.contrib.reduce_on_plateau` scale.
This class reproduces that arithmetic step for step:

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
back to the host.
"""

from __future__ import annotations

import numpy as np
import torch


B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam defaults
RTOL = 1e-4                      # optax reduce_on_plateau default


class AdamPlateau:
    def __init__(self, params, learning_rate: float,
                 weight_decay: float = 0.0, grad_clip: float = 0.0,
                 plateau_factor: float = 0.5, plateau_patience: int = 2000,
                 min_scale: float = 1e-3):
        self.params = list(params)
        self.lr, self.wd, self.clip = learning_rate, weight_decay, grad_clip
        self.factor, self.patience = plateau_factor, plateau_patience
        self.min_scale = min_scale
        dev = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
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
        self.count += 1
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(g, g), alpha=1.0 - B2)
        mu_hat = torch._foreach_div(self.mu, self._bias_correction(B1))
        nu_hat = torch._foreach_div(self.nu, self._bias_correction(B2))
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_mul_(upd, self._plateau_scale(value))
        torch._foreach_add_(self.params, upd)

    def _bias_correction(self, decay: float) -> float:
        """1 - decay**count as optax computes it, in fp32: at small
        counts the subtraction cancels, and a float64 value differs from
        the fp32 one by up to 2e-5 relative, a bias that Adam's
        normalized steps carry into every parameter."""
        return float(np.float32(1.0) - np.float32(decay**self.count))

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
