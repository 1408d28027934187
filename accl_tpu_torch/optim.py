"""AdamW for the train step's optimizer path.

The JAX package takes any parameter-local optax transform in
``make_train_step(optimizer=...)`` (accl_tpu/models/transformer.py:
450-537); its tests hold ``optax.adamw`` over dp x tp to the
single-device step.  The card has no optax, so the port has its own
AdamW, with optax's defaults and its order of operations
(optax 0.2, ``adamw`` = ``scale_by_adam`` -> ``add_decayed_weights`` ->
``scale_by_learning_rate``):

    mu     = (1 - b1) g + b1 mu
    nu     = (1 - b2) g^2 + b2 nu
    count  = count + 1
    mu_hat = mu / (1 - b1^count)
    nu_hat = nu / (1 - b2^count)
    u      = mu_hat / (sqrt(nu_hat + eps_root) + eps)
    u      = u + weight_decay p
    u      = -learning_rate u

in the parameters' dtype, the bias corrections in float32 on the
parameters' device (no host round trip).  ``adamw(...)`` returns an
object with ``init(params) -> state`` and ``update(grads, state, params)
-> (updates, state)``; the state is ``AdamWState(count, mu, nu)``, the
moments trees in the parameters' structure (the tp rank lists
included), and ``count`` an int32 scalar tensor.  ``apply_updates`` adds
the updates to the parameters in place.  The updates are plain tensor
ops: the JAX package runs this update outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .utils.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and the moments."""
    count: torch.Tensor
    mu: Any
    nu: Any


class AdamW(NamedTuple):
    """``optax.adamw``'s hyperparameters, with its ``init`` and
    ``update``."""
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    weight_decay: float = 1e-4

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))

    def update(self, grads, state: AdamWState, params):
        """(updates, new state) for the mean gradients ``grads``; the
        state's moments are updated in place and returned in the new
        state."""
        g, mu, nu = (tree_leaves(t) for t in (grads, state.mu, state.nu))
        p = tree_leaves(params)
        b1, b2 = self.b1, self.b2
        with torch.no_grad():
            for m, v, gi in zip(mu, nu, g):
                m.copy_(torch.add(gi * (1 - b1), m * b1))
                v.copy_(torch.add(torch.square(gi) * (1 - b2), v * b2))
            count = state.count + 1
            steps = count.float()
            bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                             device=steps.device), steps)
            bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                             device=steps.device), steps)
            ups = []
            for m, v, pi in zip(mu, nu, p):
                # the corrections go to each moment's card (a mesh over
                # several cards keeps each moment beside its shard)
                u = (m / bc1.to(m.device, m.dtype)) / (
                    torch.sqrt(v / bc2.to(v.device, v.dtype) + self.eps_root)
                    + self.eps)
                u = u + pi * self.weight_decay
                ups.append(u * -self.learning_rate)
        it = iter(ups)
        return (tree_map(lambda _leaf: next(it), params),
                AdamWState(count=count, mu=state.mu, nu=state.nu))


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> AdamW:
    """AdamW with optax's defaults (``optax.adamw``; no mask, no Nesterov
    momentum, moments in the parameters' dtype)."""
    return AdamW(learning_rate, b1, b2, eps, eps_root, weight_decay)


def apply_updates(params, updates):
    """``params + updates``, leaf by leaf, in place (``optax.apply_updates``
    returns new arrays; the port updates the parameters it was given, as
    its SGD step does).  Returns ``params``."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u.to(p.dtype))
    return params
