"""The train step: forward with targets, three losses, backward, guarded AdamW.

Mirrors ``skghoi_tpu.parallel.train_step.build_train_step`` (the reference's
per-iteration hot path, ``utils.py:213-229``), in the same order: the
forward with ``training=True``, the selected losses summed, the backward
(through the CUDA RoIAlign kernel's adjoint on the card), and the AdamW
update, applied only when the total loss and every gradient are finite.  A
skipped update leaves the parameters, the AdamW moments and step counts and
the schedule's count exactly as they were; the gradients are zeroed.

The guard reads one flag on the host per step: the step waits there for the
backward to finish before it issues the update (``PERF.md`` gives the cost).

Under data parallelism (a process group from
:mod:`skghoi_torch.parallel.distributed`) the gradients, the total and the
losses are averaged over the ranks by one flat all-reduce after the
backward (:func:`~skghoi_torch.parallel.mesh.all_reduce_mean_`): every rank
then holds the whole batch's gradient and losses (the losses' normalisers
are global, see ``InteractionHead._compute_losses``), and the guard reads
the averaged values, so a NaN on any rank skips the update on all of them.
This is the explicit counterpart of the ``psum`` that XLA inserts in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from skghoi_torch.parallel.mesh import all_reduce_mean_
from skghoi_torch.utils.profiling import span

ALL_LOSSES = ("hoi_loss", "interactiveness_loss", "transh_loss")


def all_finite(total: torch.Tensor, grads: Sequence[torch.Tensor]) -> bool:
    """The NaN guard's one host read: whether ``total`` and every entry of
    every gradient are finite."""
    # The largest |g| of each tensor: NaN or inf if any entry is.
    peaks = torch.stack(torch._foreach_norm(list(grads), float("inf")))
    return bool(torch.isfinite(total) & torch.isfinite(peaks).all())


def build_train_step(model, optimizer: torch.optim.Optimizer, object_verb_mask: torch.Tensor,
                     loss_keys: Optional[Sequence[str]] = None) -> Callable:
    """Returns ``step(batch, generator=None, gumbel=None) -> (total, losses,
    out, applied)``, with ``step.model`` and ``step.optimizer`` attached.

    ``loss_keys`` selects the losses that drive the gradients, as the
    reference's engine variants do (``utils.py:200-424``): all three by
    default; ``("transh_loss",)`` is ``transH_CustomisedDLE``;
    ``("hoi_loss", "interactiveness_loss")`` is ``OriginalCustomisedDLE``.
    Every parameter of the optimizer gets a gradient each step (zeros where
    the selected losses do not reach it), so AdamW decays and updates its
    moments for all of them, as optax does.
    """
    keys = tuple(loss_keys) if loss_keys else ALL_LOSSES
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch, generator: Optional[torch.Generator] = None,
             gumbel: Optional[torch.Tensor] = None):
        optimizer.zero_grad(set_to_none=False)
        with span("forward"):
            out = model(batch, object_verb_mask, training=True, generator=generator, gumbel=gumbel)
        total = sum(out.losses[k] for k in keys)
        with span("backward"):
            total.backward()
        for p in params:  # first step: parameters the selected losses do not reach
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        total = total.detach()
        losses = {k: v.detach() for k, v in out.losses.items()}
        # One all-reduce averages the gradients, the total and the losses.
        all_reduce_mean_([*grads, total, *losses.values()])
        with span("guard"):
            applied = all_finite(total, grads)
        with span("optimizer"):
            if applied:
                optimizer.step()
            else:
                optimizer.zero_grad(set_to_none=False)
        return total, losses, out, applied

    step.model, step.optimizer = model, optimizer
    return step


def build_eval_step(model, object_verb_mask: torch.Tensor) -> Callable:
    """Returns ``eval_step(batch) -> InteractionOutputs``: the inference
    forward, without gradients and with the targets dropped (JAX
    ``build_eval_step``)."""

    @torch.no_grad()
    def eval_step(batch):
        return model(batch._replace(targets=None), object_verb_mask, training=False)

    return eval_step
