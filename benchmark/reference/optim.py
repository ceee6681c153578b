"""Plain optimizers of the reference's training steps, by the name a
traffic mix gives under `optim`."""
from __future__ import annotations

import math

import torch


class Adam:
    """Adam (betas 0.9, 0.999; eps 1e-5 outside the square root) over
    named parameters; `grads` of the first step are kept."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-5):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr / c1 * self.m[k] / (self.v[k].sqrt() / math.sqrt(c2) + self.eps))


OPTIMIZERS = {"adam": Adam}
