"""KGE trainer: an epoch is ``nbatches`` device steps with no host read.

Mirrors ``skghoi_tpu.kge.trainer`` (the reference
``OpenKE/openke/config/Trainer.py:56-99``).  Each step draws its batch on the
device (:func:`~skghoi_torch.kge.sampling.sample_batch`, or the one-side
form), evaluates the strategy loss, and applies a ``torch.optim`` update.
The epoch's loss is summed on the device; the host reads it only for the
log line (``Epoch {ep} | loss: ...``, every 50 epochs and the last), which
also makes the last epoch's end a synchronisation point.

:func:`make_optimizer` maps the JAX package's four rules onto
``torch.optim`` with optax's hyper-parameters: SGD; Adam (b1 0.9, b2 0.999,
eps 1e-8); Adagrad with torch's own rule ``g / (sqrt(accum) + 1e-10)`` and a
zero initial accumulator (what ``_torch_adagrad`` imitates in JAX); Adadelta
(rho 0.9, eps 1e-6).  ``weight_decay`` is L2 coupled into the gradient in
every rule, as ``optax.add_decayed_weights`` chained before the rule.

``batches``, when given, is a callable that returns each step's batch
(numpy arrays or tensors; :func:`~skghoi_torch.kge.sampling.batch_to` moves
it), in place of the device sampler: the parity tests feed the port and the
JAX package the same batches this way.

With a process group up (:mod:`skghoi_torch.parallel.distributed`) the
trainer is data parallel over its ranks, as JAX's ``shard_map`` over the
``data`` mesh is (``skghoi_tpu/kge/trainer.py:123-160``): each rank draws
``batch_size // world_size`` rows from its own generator (seeded ``seed +
rank``), and after the backward one all-reduce averages the gradients and
the loss, so every rank applies the same update.  With no group it is a
rank of one, and all three are the identity.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

from skghoi_torch.kge.sampling import Batch, DeviceKG, batch_to, sample_batch, sample_batch_oneside
from skghoi_torch.kge.strategy import NegativeSampling
from skghoi_torch.parallel.distributed import rank, world_size
from skghoi_torch.parallel.mesh import all_reduce_mean_


def make_optimizer(opt_method: str, params, alpha: float,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    m = opt_method.lower()
    if m == "adagrad":
        return torch.optim.Adagrad(params, lr=alpha, initial_accumulator_value=0.0, eps=1e-10,
                                   weight_decay=weight_decay)
    if m == "adadelta":
        return torch.optim.Adadelta(params, lr=alpha, rho=0.9, eps=1e-6, weight_decay=weight_decay)
    if m == "adam":
        return torch.optim.Adam(params, lr=alpha, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    return torch.optim.SGD(params, lr=alpha, weight_decay=weight_decay)  # reference default


class Trainer:
    def __init__(
        self,
        model,
        strategy: NegativeSampling,
        kg: DeviceKG,
        nbatches: int = 100,
        neg_rate: int = 1,
        bern: bool = False,
        filtered: bool = True,
        train_times: int = 1000,
        alpha: float = 0.5,
        opt_method: str = "sgd",
        weight_decay: float = 0.0,
        log_fn: Callable[[str], None] = print,
        seed: int = 0,
        sampling_mode: str = "normal",
        batches: Optional[Callable[[], Batch]] = None,
    ):
        self.model = model
        self.strategy = strategy
        self.kg = kg
        self.nbatches = nbatches
        self.train_times = train_times
        self.log_fn = log_fn
        self.optimizer = make_optimizer(opt_method, model.parameters(), alpha, weight_decay)
        self.batch_size = max(1, int(len(kg.train_h) / nbatches) // world_size())
        self.generator = torch.Generator(device=kg.device).manual_seed(seed + rank())
        if batches is not None:
            self._next_batch = lambda: batch_to(batches(), kg.device)
        else:
            sampler = sample_batch_oneside if sampling_mode == "oneside" else sample_batch
            self._next_batch = lambda: sampler(self.generator, kg, self.batch_size, neg_rate,
                                               bern=bern, filtered=filtered)

    def step(self) -> torch.Tensor:
        """One batch, loss, backward and update; the loss stays on the device."""
        loss = self.strategy(self.model, self._next_batch())
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        all_reduce_mean_([p.grad for p in self.model.parameters() if p.grad is not None] + [loss])
        self.optimizer.step()
        return loss

    def run_epoch(self) -> torch.Tensor:
        """``nbatches`` steps; the sum of their losses, on the device."""
        total = torch.zeros((), device=self.kg.device)
        for _ in range(self.nbatches):
            total += self.step()
        return total

    def run(self):
        t0 = time.time()
        for ep in range(self.train_times):
            loss = self.run_epoch()
            if ep % 50 == 0 or ep == self.train_times - 1:
                self.log_fn(f"Epoch {ep} | loss: {float(loss):f} | {time.time() - t0:.1f}s elapsed")
        return self.model

    def save_checkpoint(self, path: str):
        """The model's ``state_dict`` (OpenKE's table names) via ``torch.save``."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(self.model.state_dict(), path)

    def load_checkpoint(self, path: str):
        self.model.load_state_dict(torch.load(path, map_location=self.kg.device, weights_only=True))
