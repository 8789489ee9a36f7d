"""The optimizer zoo, with optax's update rules (counterpart of
``maskrcnn_tf2_tpu/train/optimizer.py``).

adam, adamax, adadelta, adagrad, sgd, rmsprop and the repo's own ftrl, each
at optax's defaults, behind optional ``clipvalue`` and ``clipnorm``, with the
learning rate injected into the state so that ``set_learning_rate`` changes
it between steps. ``torch.optim`` differs from optax in places (rmsprop puts
eps inside the square root and decays at 0.9; adagrad starts its accumulator
at 0.1 with eps 1e-7), so every rule is written out here on lists of tensors
with ``torch._foreach_*`` ops, in optax's order of operations.

An optimizer is functional: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, new_state)``; the caller adds the
updates (``p + u``) and keeps or drops the new state.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

Tensors = List[torch.Tensor]


class OptState(NamedTuple):
    count: int  # updates applied so far
    hyperparams: Dict[str, float]  # {"learning_rate": lr}
    slots: Dict[str, Tensors]  # per-parameter accumulators


class Optimizer(NamedTuple):
    init: Callable[[Tensors], OptState]
    update: Callable[[Tensors, OptState, Tensors], tuple]


def _zeros(params: Tensors) -> Tensors:
    return [torch.zeros_like(p) for p in params]


def _full(params: Tensors, value: float) -> Tensors:
    return [torch.full_like(p, value) for p in params]


def _moment(g: Tensors, m: Tensors, decay: float) -> Tensors:
    """``(1 - decay) * g + decay * m``."""
    return torch._foreach_add(torch._foreach_mul(g, 1 - decay), torch._foreach_mul(m, decay))


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _adam(g, slots, count, b1=0.9, b2=0.999, eps=1e-8):
    mu = _moment(g, slots["mu"], b1)
    nu = _moment(torch._foreach_mul(g, g), slots["nu"], b2)
    mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
    nu_hat = torch._foreach_div(nu, _bias_correction(b2, count))
    u = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), eps))
    return u, {"mu": mu, "nu": nu}


def _adamax(g, slots, count, b1=0.9, b2=0.999, eps=1e-8):
    mu = _moment(g, slots["mu"], b1)
    nu = torch._foreach_maximum(torch._foreach_add(torch._foreach_abs(g), eps),
                                torch._foreach_mul(slots["nu"], b2))
    u = torch._foreach_div(torch._foreach_div(mu, _bias_correction(b1, count)), nu)
    return u, {"mu": mu, "nu": nu}


def _adadelta(g, slots, count, rho=0.9, eps=1e-6):
    e_g = _moment(torch._foreach_mul(g, g), slots["e_g"], rho)
    ratio = torch._foreach_div(torch._foreach_sqrt(torch._foreach_add(slots["e_x"], eps)),
                               torch._foreach_sqrt(torch._foreach_add(e_g, eps)))
    u = torch._foreach_mul(ratio, g)
    e_x = _moment(torch._foreach_mul(u, u), slots["e_x"], rho)
    return u, {"e_g": e_g, "e_x": e_x}


def _adagrad(g, slots, count, eps=1e-7):
    acc = torch._foreach_add(torch._foreach_mul(g, g), slots["sum_of_squares"])
    inv = [torch.where(a > 0, torch.rsqrt(a + eps), 0.0) for a in acc]
    return torch._foreach_mul(inv, g), {"sum_of_squares": acc}


def _rmsprop(g, slots, count, decay=0.9, eps=1e-8):
    nu = _moment(torch._foreach_mul(g, g), slots["nu"], decay)
    return torch._foreach_mul(torch._foreach_rsqrt(torch._foreach_add(nu, eps)), g), {"nu": nu}


def _sgd(g, slots, count):
    return list(g), {}


# name -> (update rule, slot initializers); the rule's updates are then
# scaled by -learning_rate, as optax's scale_by_learning_rate does
_RULES = {
    "adam": (_adam, {"mu": _zeros, "nu": _zeros}),
    "adamax": (_adamax, {"mu": _zeros, "nu": _zeros}),
    "adadelta": (_adadelta, {"e_g": _zeros, "e_x": _zeros}),
    "adagrad": (_adagrad, {"sum_of_squares": lambda ps: _full(ps, 0.1)}),
    "rmsprop": (_rmsprop, {"nu": _zeros}),
    "sgd": (_sgd, {}),
}


def _ftrl_update(g, slots, params, lr, lr_power=-0.5, l1=0.0, l2=0.0):
    """FTRL-proximal (the JAX package's ``ftrl``): returns ``p_new - p``."""
    updates, n_out, z_out = [], [], []
    for gi, n, z, p in zip(g, slots["n"], slots["z"], params):
        n_new = n + gi * gi
        sigma = (n_new ** -lr_power - n ** -lr_power) / lr
        z_new = z + gi - sigma * p
        denom = n_new ** -lr_power / lr + 2.0 * l2
        p_new = torch.where(torch.abs(z_new) <= l1, 0.0, -(z_new - torch.sign(z_new) * l1) / denom)
        updates.append(p_new - p)
        n_out.append(n_new)
        z_out.append(z_new)
    return updates, {"n": n_out, "z": z_out}


def sum_of_squares(g: Tensors) -> torch.Tensor:
    return sum(torch.sum(t * t) for t in g)


def build_optimizer(config, sum_squares: Callable[[Tensors], torch.Tensor] = sum_of_squares) -> Optimizer:
    """The optimizer of ``config.optimizer`` behind ``clipvalue`` then
    ``clipnorm``, at ``config.learning_rate``. ``clipnorm``'s global norm is
    ``sqrt(sum_squares(grads))``: a tensor-parallel step passes one that
    counts each shard's squares once over its model group."""
    name = config.optimizer.lower()
    if name not in _RULES and name != "ftrl":
        raise ValueError(f"unsupported optimizer '{name}'; available: {sorted([*_RULES, 'ftrl'])}")
    clipvalue, clipnorm = config.clipvalue, config.clipnorm

    def init(params: Tensors) -> OptState:
        makers = {"n": _zeros, "z": _zeros} if name == "ftrl" else _RULES[name][1]
        slots = {k: make(list(params)) for k, make in makers.items()}
        return OptState(0, {"learning_rate": float(config.learning_rate)}, slots)

    def update(grads: Tensors, state: OptState, params: Tensors):
        g = list(grads)
        if clipvalue is not None:
            g = [torch.clamp(t, -clipvalue, clipvalue) for t in g]
        if clipnorm is not None:
            norm = torch.sqrt(sum_squares(g))
            g = [torch.where(norm < clipnorm, t, (t / norm) * clipnorm) for t in g]
        lr = state.hyperparams["learning_rate"]
        count = state.count + 1
        if name == "ftrl":
            updates, slots = _ftrl_update(g, state.slots, list(params), lr)
        else:
            updates, slots = _RULES[name][0](g, state.slots, count)
            updates = torch._foreach_mul(updates, -lr)
        return updates, OptState(count, dict(state.hyperparams), slots)

    return Optimizer(init, update)


def set_learning_rate(opt_state: OptState, lr: float) -> OptState:
    """The state with its injected learning rate replaced."""
    return opt_state._replace(hyperparams={**opt_state.hyperparams, "learning_rate": float(lr)})
