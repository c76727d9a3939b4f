"""Learning engine: the training loop with the reference's log lines.

Mirrors ``skghoi_tpu.train.engine`` (reference ``utils.py:200-299`` over
pocket's ``DistributedLearningEngine``): per iteration the batch goes to the
device, the train step runs (forward, losses, backward, NaN-guarded AdamW),
the losses are read on the host (a NaN HOI loss raises, ``utils.py:218-219``)
and the outputs feed the training mAP meter; every ``print_interval``
iterations the mean losses are printed; after each epoch the training and
validation mAP are printed as

    Epoch: {e} | training mAP: x, evaluation time: t |validation mAP: y, ...

(the line ``tools/learning_curve.py`` parses) and a checkpoint with the
reference's keys is written to ``cache_dir/ckpt_{epoch:02d}.pt``.

The TransH sampler's Gumbel noise comes from a seeded ``torch.Generator`` on
the device, or from ``gumbel()``, a callable that returns each iteration's
``[B, 15*30*117]`` noise (the tests replay the JAX engine's draws).  As in
JAX, :meth:`LearningEngine.resume` restores the weights, the optimizer and
the counters, not the noise stream.

Under data parallelism (a process group from
:mod:`skghoi_torch.parallel.distributed`, one process per card) each rank
trains on its shard of the data (the loaders' ``num_shards``/``shard_index``,
the reference's ``DistributedSampler``); the train step averages gradients
and losses over the ranks.  The ranks run the same number of steps an epoch:
a rank whose shard gives fewer batches takes its first batches again, as
``DistributedSampler`` repeats samples to even the shards out, and those
repeats do not feed the training mAP.  Each rank takes its rows of one global
Gumbel draw (``[world * B, ...]``, the same generator seed on every rank).
The per-image results of every rank are gathered before the training and the
validation mAP, and only rank 0 prints the log lines and writes checkpoints.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from skghoi_torch import constants as C
from skghoi_torch.data.device_preprocess import prepare_batch
from skghoi_torch.data.factory import to_device
from skghoi_torch.eval.hoi_eval import to_numpy, unpack_image_results
from skghoi_torch.models.graph_head import gumbel_noise
from skghoi_torch.ops.ap import BoxPairAssociation, DetectionAPMeter
from skghoi_torch.parallel.distributed import is_main, rank, world_size
from skghoi_torch.parallel.mesh import all_gather_object, all_reduce_max
from skghoi_torch.parallel.train_step import build_eval_step, build_train_step
from skghoi_torch.train.checkpoint import (
    load_checkpoint,
    load_model_state,
    save_checkpoint,
)
from skghoi_torch.train.optimizer import build_optimizer


class RunningMeter:
    """Cross-interval loss averaging (SyncedNumericalMeter stand-in)."""

    def __init__(self):
        self.reset()

    def append(self, value: float):
        self.total += float(value)
        self.count += 1

    def mean(self) -> float:
        return self.total / max(self.count, 1)

    def reset(self):
        self.total = 0.0
        self.count = 0


class LearningEngine:
    """Trains ``model`` (its parameters as they are, on its device) over
    ``train_loader``; ``val_loader`` gives the validation mAP of each epoch.

    ``iteration_ends`` holds the host clock at the end of each iteration of
    the last :meth:`run` (after its losses reached the host), and
    ``step_losses`` that iteration's three losses as floats."""

    def __init__(
        self,
        model,
        train_loader,
        val_loader=None,
        num_classes: int = C.HICO_NUM_VERBS,
        object_verb_mask=None,
        print_interval: int = 100,
        cache_dir: str = "./checkpoints",
        learning_rate: float = C.LEARNING_RATE,
        lr_decay: float = C.LR_DECAY_BACKBONE,
        weight_decay: float = C.WEIGHT_DECAY,
        milestones: Sequence[int] = (C.LR_MILESTONE_EPOCH,),
        seed: int = 0,
        loss_keys: Optional[Sequence[str]] = None,
        gumbel: Optional[Callable[[], torch.Tensor]] = None,
    ):
        if object_verb_mask is None:
            raise ValueError("object_verb_mask (e.g. dataset.object_verb_mask()) is required")
        self.model = model
        self.device = next(model.parameters()).device
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.num_classes = num_classes
        self.print_interval = print_interval
        self.cache_dir = cache_dir
        self.epoch = 0
        self.iteration = 0
        self.iteration_ends, self.step_losses = [], []
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.gumbel = gumbel

        ovm = torch.as_tensor(np.asarray(object_verb_mask, np.float32), device=self.device)
        self.optimizer = build_optimizer(
            model, learning_rate=learning_rate, lr_decay=lr_decay, weight_decay=weight_decay,
            steps_per_epoch=max(all_reduce_max(len(train_loader)), 1), milestones=milestones,
        )
        self.train_step = build_train_step(model, self.optimizer, ovm, loss_keys=loss_keys)
        self.eval_step = build_eval_step(model, ovm)

        self.hoi_loss = RunningMeter()
        self.intr_loss = RunningMeter()
        self.transh_loss = RunningMeter()

    # ------------------------------------------------------------------
    def _to_device(self, batch, loader):
        """The collated numpy batch on the model's device; raw uint8 batches
        (``DataFactory(device_resize=True)``) get their resize and canvas
        there."""
        return prepare_batch(to_device(batch, self.device), loader.factory)

    def _epoch_batches(self):
        """``(batch, indices, repeat)`` for as many steps as the longest
        rank's shard has batches this epoch: the loader's batches, then its
        first ones again where this rank's shard ran short (``repeat`` True)."""
        own = len(self.train_loader)
        steps, step = all_reduce_max(own), 0
        if steps and not own:
            raise RuntimeError(f"rank {rank()} has no training batch in its shard")
        while step < steps:
            for batch, indices in self.train_loader:
                if step == steps:
                    return
                yield batch, indices, step >= own
                step += 1

    def _gumbel(self, batch_size: int) -> torch.Tensor:
        """This rank's rows of the step's global TransH noise."""
        lo, hi = rank() * batch_size, (rank() + 1) * batch_size
        if self.gumbel is not None:
            return self.gumbel()[lo:hi].to(self.device)
        cols = C.MAX_HUMAN * C.MAX_BOXES * self.num_classes
        return gumbel_noise((world_size() * batch_size, cols), self.generator, self.device)[lo:hi]

    def run(self, num_epochs: int):
        self.iteration_ends, self.step_losses = [], []
        for _ in range(num_epochs):
            self.train_loader.set_epoch(self.epoch)
            meter = DetectionAPMeter(self.num_classes, algorithm="11P")
            for batch, indices, repeat in self._epoch_batches():
                _, _, out, _ = self.train_step(
                    self._to_device(batch, self.train_loader),
                    gumbel=self._gumbel(len(batch.images)))
                out = to_numpy(out)  # one pass to the host: losses and outputs
                losses = out.losses
                hoi = float(losses["hoi_loss"])
                if np.isnan(hoi):
                    raise ValueError("The HOI loss is NaN")  # utils.py:218-219
                self.step_losses.append({k: float(v) for k, v in losses.items()})
                self.hoi_loss.append(hoi)
                self.intr_loss.append(float(losses["interactiveness_loss"]))
                self.transh_loss.append(float(losses["transh_loss"]))
                if out.metrics is not None:
                    dropped = float(out.metrics.get("transh_pos_dropped", 0.0))
                    if dropped > 0:
                        # The capped TransH sampler truncated positives this
                        # step (ref samples all, :936-943) — never silent.
                        print(f"=> TransH sampler dropped {dropped:.0f} positives over the cap")
                self.iteration += 1
                if self.iteration % self.print_interval == 0:
                    self._print_statistics()
                if not repeat:
                    self._log_results(out, batch, indices, meter)
                self.iteration_ends.append(time.perf_counter())
            self._on_end_epoch(meter)
        return self.model

    def _print_statistics(self):
        if is_main():
            print(
                f"=> HOI classification loss: {self.hoi_loss.mean():.4f},",
                f"interactiveness loss: {self.intr_loss.mean():.4f},",
                f"transH loss: {self.transh_loss.mean():.4f}",
            )
        self.hoi_loss.reset()
        self.intr_loss.reset()
        self.transh_loss.reset()

    def _log_results(self, out, batch, indices, meter: DetectionAPMeter):
        """Feed the train meter from the host outputs, over the batch's real
        images only (a short batch repeats its last sample as padding)."""
        if out.labels is None:
            return
        for slot, _ in enumerate(indices):
            res = unpack_image_results(out, batch, slot)
            x, y = res["pair_index"][:, 0], res["pair_index"][:, 1]
            k = res["prediction"]
            meter.append(res["scores"], k, out.labels[slot, x, y, k])

    @staticmethod
    def _mean_ap(meter: DetectionAPMeter) -> float:
        """Mean AP over what every rank's ``meter`` holds, rank by rank."""
        merged = DetectionAPMeter(meter.num_cls, meter.num_gt, meter.algorithm)
        for part in all_gather_object((meter._scores, meter._labels)):
            for c, (scores, labels) in enumerate(zip(*part)):
                merged._scores[c].extend(scores)
                merged._labels[c].extend(labels)
        return float(merged.eval().mean())

    def _on_end_epoch(self, meter: DetectionAPMeter):
        t0 = time.time()
        ap_train = self._mean_ap(meter)
        t_train = time.time() - t0

        t0 = time.time()
        ap_val = self.validate() if self.val_loader is not None else 0.0
        t_val = time.time() - t0

        if is_main():
            print(
                "Epoch: {} | training mAP: {:.4f}, evaluation time: {:.2f}s |"
                "validation mAP: {:.4f}, total time: {:.2f}s\n".format(
                    self.epoch, ap_train, t_train, ap_val, t_val
                )
            )
        self.epoch += 1
        if is_main():
            self.save()

    def validate(self) -> float:
        """Verb-level mAP over ``val_loader``: detections associated with the
        ground-truth pairs of the same verb at IoU 0.5, over every rank's
        shard of it."""
        meter = DetectionAPMeter(self.num_classes, algorithm="11P")
        assoc = BoxPairAssociation(min_iou=0.5)
        for batch, indices in self.val_loader:
            out = to_numpy(self.eval_step(self._to_device(batch, self.val_loader)))
            for slot, ds_index in enumerate(indices):
                res = unpack_image_results(out, batch, slot)
                target = self.val_loader.factory.dataset.raw_target(ds_index)
                gt_h = np.asarray(target["boxes_h"], np.float64).reshape(-1, 4)
                gt_o = np.asarray(target["boxes_o"], np.float64).reshape(-1, 4)
                gt_h[:, :2] -= 1
                gt_o[:, :2] -= 1
                gt_verbs = np.asarray(target.get("verb", target.get("actions", []))).reshape(-1)
                labels = np.zeros_like(res["scores"])
                for v in np.unique(res["prediction"]):
                    gt_sel = np.nonzero(gt_verbs == v)[0]
                    det_sel = np.nonzero(res["prediction"] == v)[0]
                    if len(gt_sel):
                        labels[det_sel] = assoc(
                            (gt_h[gt_sel], gt_o[gt_sel]),
                            (res["boxes_h"][det_sel], res["boxes_o"][det_sel]),
                            res["scores"][det_sel],
                        )
                meter.append(res["scores"], res["prediction"], labels)
        return self._mean_ap(meter)

    def save(self):
        os.makedirs(self.cache_dir, exist_ok=True)
        save_checkpoint(os.path.join(self.cache_dir, f"ckpt_{self.epoch:02d}.pt"),
                        self.model.state_dict(), self.optimizer.state_dict(), self.epoch,
                        self.iteration)

    def resume(self, path: str):
        """Weights, optimizer state (moments, step counts, each group's lr
        and applied steps), epoch and iteration from a checkpoint."""
        ckpt = load_checkpoint(path)
        load_model_state(self.model, ckpt["model_state_dict"])
        self.optimizer.load_state_dict(ckpt["optim_state_dict"])
        self.epoch = int(ckpt["epoch"])
        self.iteration = int(ckpt["iteration"])
