"""AdaMixer-R50 training, closed loop, one process: each step takes a
collated numpy batch from the pool through the program's
``tools.train_detector.train_batch`` (``to_device``, the detector's ground
truth, its de-duplication on the host, and the step of
``build_adamixer_step``: the forward, the host Hungarian of each (stage,
image), the set loss, the backward and AdamW over the trainable parameters)
and reads the set loss back, as ``train_detector`` prints it.  The model is
``AdaMixerDetector`` at the configuration's widths with ``frozen_stages``
from it, its weights the seed's.

Set-up builds the one model, AdamW and step, and drives them through their
first steps on the pool's first batches, keeping for the check the losses of
steps 1-3, step 1's outputs of every stage (a forward hook on the decoder)
and its assignments (the program's own ``compute_assignments``, recorded as
it returns), the first gradient as AdamW holds it after step 1 (its first
moment over 1 - beta1) and the change of every trainable parameter after
step 3; then it warms every canvas of the pool twice.  The window goes on
with the same objects.  ``release`` copies their parameters and AdamW state,
drives them through two more steps, keeping their losses, the gradient that
each gave AdamW (and the first's again from AdamW's moments before and after
it), the parameters between the two and the change over the two, and reads
every tensor the reference keeps frozen against the seed's; then it frees
the program.

The check runs the reference's first three steps from the seed's weights,
and each late step from the program's own parameters before it, on the same
batches: a late step taken from the reference's own last update would carry
that update's float32 round-off, which AdamW's update, scaled to each
element's own gradient, lifts to the control's size in some late states.  Its
numbers: ``loss_gap`` (step 1's relative set-loss gap, before any update),
``logit_gap`` and ``box_gap`` (step 1's last stage: the largest difference
over the reference's largest magnitude), ``assign_diff`` (step 1's
assignments of a ground-truth box that differ, in the (stage, image)
problems whose two matchings do not cost the same under the reference's
costs within ``TIE_RTOL``), ``grad_gap`` (the worst leaf's first-gradient
gap outside the box branch), ``box_grad_gap`` (the worst leaf's inside it:
the ``reg_fc*`` and ``fc_reg`` layers of every stage, whose gradient reaches
the loss through every later stage's sampling points, where bilinear
sampling's slope jumps at each pixel edge; a float64 reference puts the
float32 reference's own box leaves up to 0.07 from it, so they take a wider
limit), ``change_gap`` (the worst leaf's change after step 3: AdamW's first
steps move each element by about lr whatever its gradient's size, so this
reads the update's signs, not the gradient's scale), ``late_loss_gap`` (the
late steps' worst loss gap over the first late reference loss),
``late_grad_gap`` (the first late gradient's median leaf; the worst leaf's
is read beside it), ``late_change_gap`` (the worst leaf's gap between the
program's change over the late steps and the change that the reference's
AdamW makes from the same state with the program's own late gradients: the
update alone, as ``late_grad_gap`` holds the gradient) and ``frozen_moved``
(the largest change of a frozen tensor, exact).  Leaf gaps are ``hoibench.checks.leaf_gaps`` over the
leaves whose reference gradient is at least a thousandth of the median
leaf's.
"""

from __future__ import annotations

import math
import re
import time
from typing import Dict, Optional
from unittest import mock

import numpy as np
import torch

from hoibench.checks import (leaf_gaps, median_leaf, moving_leaves, relative_gap, scaled_max_gap,
                             worst, worst_leaf)
from hoibench.drivers.common import as_hoibatch, reference_batch, sync
from hoibench.drivers import scg_train
from hoibench.drivers.scg_train import BETA1, _moments, _norms
from hoibench.reference import adamixer as ref
from hoibench.trace import span
from hoibench.traffic import make_pool
from hoibench.weights import make_state
from skghoi_torch.detect import adamixer
from skghoi_torch.detect.adamixer import AdaMixerDetector
from skghoi_torch.tools.train_detector import adamw, build_adamixer_step, train_batch

CHECKED_STEPS = 3
LATE_STEPS = 2
# Two matchings whose totals under the reference's costs lie this close are
# a tie that either may take (float32 costs of up to 24 boxes).
TIE_RTOL = 1e-4
# The box branch's leaves, held apart by ``box_grad_gap``.
BOX_BRANCH = re.compile(r"\.(reg_fc\d+|fc_reg)\.")
MODEL_KEYS = ("num_classes", "num_queries", "num_stages", "content_dim", "groups", "in_points",
              "out_points", "ffn_dim", "frozen_stages")


def assign_diff(got: np.ndarray, want: np.ndarray, ties) -> int:
    """Ground-truth boxes assigned differently, outside the problems that
    ``ties`` (one flag for each problem that differs, in order) calls tied;
    every slot where the shapes differ."""
    if got.shape != want.shape:
        return int(want.size)
    differ = (got != want)
    problems = list(zip(*np.nonzero(differ.any(-1))))
    return int(sum(differ[s, b].sum() for (s, b), tie in zip(problems, ties) if not tie))


class Driver:
    def __init__(self, cell: dict, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell["config_params"], cell["traffic_params"]
        self.attempted = self.failed = 0
        self.compile_s = 0.0

    def reference_model(self, precision: str = "float32", device=None) -> ref.AdaMixer:
        with torch.device(device or self.device):
            return ref.AdaMixer(self.config, ref.quantizer(precision))

    def state(self) -> Dict[str, torch.Tensor]:
        meta = self.reference_model(device="meta")
        return make_state(meta, meta.init_kinds(), self.seed, self.device)

    def program_model(self) -> AdaMixerDetector:
        model = AdaMixerDetector(**{k: self.config[k] for k in MODEL_KEYS}, device=self.device)
        model.load_state_dict(self.state())
        return model

    def setup(self) -> None:
        self.pool = make_pool(self.traffic, self.seed, self.device)
        model = self.program_model()
        opt = adamw(model, self.config["learning_rate"], self.config["weight_decay"])
        self.model, self.opt = model, opt
        self.step = build_adamixer_step(model, opt)
        self.i = 0
        self.program = self._first_steps(model, opt)
        seen: Dict[tuple, int] = {}
        while min(seen.values(), default=0) < 2 or len(seen) < len(self.traffic["canvases"]):
            canvas = self.pool[self.i % len(self.pool)]["images"].shape[1:3]
            seen[canvas] = seen.get(canvas, 0) + 1
            self._step()
        sync(self.device)

    def _step(self) -> float:
        b = self.pool[self.i % len(self.pool)]
        self.i += 1
        losses = train_batch(self.step, as_hoibatch(b), self.device, "adamixer")
        with span("read_losses"):
            return losses["set_loss"].item()

    def _first_steps(self, model, opt) -> dict:
        trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
        start = {n: p.detach().clone() for n, p in trainable.items()}
        outputs, matched = [], []
        real = adamixer.compute_assignments

        def recorded(*args, **kwargs):
            matched.append(real(*args, **kwargs))
            return matched[-1]

        hook = model.decoder.register_forward_hook(
            lambda m, i, o: outputs.append([t.detach().cpu() for t in o]))
        try:
            with mock.patch.object(adamixer, "compute_assignments", recorded):
                losses = [self._step()]
        finally:
            hook.remove()
        grads = _norms(_moments(model, opt, "exp_avg"), 1.0 / (1.0 - BETA1))
        losses += [self._step() for _ in range(CHECKED_STEPS - 1)]
        change = _norms({n: p.detach() - start[n] for n, p in trainable.items()})
        logits, boxes = outputs[0]
        return dict(losses=losses, grads=grads, change=change, logits=logits, boxes=boxes,
                    assign=matched[0])

    def window(self, seconds: float) -> dict:
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            loss = self._step()
            self.attempted += 1
            self.failed += not math.isfinite(loss)
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        self.unit_s = elapsed / self.attempted
        return {"train_img_per_s": self.attempted * self.traffic["batch"] / elapsed}

    def run_units(self, n: int) -> None:
        for _ in range(n):
            with span("step"):
                self._step()

    def release(self) -> None:
        """Copy the timed objects' state, drive them through the late steps,
        read the frozen tensors, and free the program."""
        model, opt = self.model, self.opt
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        m0, v0 = ({n: t.clone() for n, t in _moments(model, opt, key).items()}
                  for key in ("exp_avg", "exp_avg_sq"))
        self.late_start = dict(i=self.i, t=self.i, params=params, m=m0, v=v0)
        trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        losses, grads, step_grads, later = [], {}, [], []
        for k in range(LATE_STEPS):
            losses.append(self._step())
            step_grads.append({n: p.grad.detach().clone() for n, p in trainable})
            if k + 1 < LATE_STEPS:
                later.append({n: p.detach().clone() for n, p in trainable})
            if k == 0:
                m1 = _moments(model, opt, "exp_avg")
                grads = _norms({n: m1[n] - BETA1 * m0[n] for n in m1}, 1.0 / (1.0 - BETA1))
        # Contiguous, as the reference's tensors are, so that a norm sums in the same order.
        change = _norms({n: (p.detach() - params[n]).contiguous()
                         for n, p in model.named_parameters() if p.requires_grad})
        self.late_start["later"] = later
        self.program.update(late_losses=losses, late_grads=grads, late_change=change,
                            late_step_grads=step_grads,
                            frozen_moved=self._frozen_moved(model.state_dict()))
        self.step = self.model = self.opt = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # The reference's frozen tensors against the seed's, as the SCG cell reads them.
    _frozen_moved = scg_train.Driver._frozen_moved

    def flop_fn(self, canvas):
        """The reference's forward and backward of one step at ``canvas``, on
        meta tensors (every output takes a gradient, as under the set loss)."""
        batch = self.traffic["batch"]

        def run():
            model = self.reference_model(device="meta")
            logits, boxes = model(torch.empty((batch, *canvas, 3), device="meta"))
            (logits.sum() + boxes.sum()).backward()

        return run

    def reference(self, precision: str = "float32") -> ref.AdaMixer:
        model = self.reference_model(precision)
        model.load_state_dict(self.state())
        return model

    def _reference_steps(self, model, opt, first: int, n: int, keep_grads: bool = False):
        """``n`` reference steps on the pool's batches from ``first``: their
        losses, and the first step's gradients, outputs, assignments and
        batch; with ``keep_grads``, each step's gradients (``step_grads``)."""
        losses, head, step_grads = [], {}, []
        for k in range(n):
            b = reference_batch(self.pool[(first + k) % len(self.pool)], self.device)
            loss, g, (logits, boxes), assign = ref.train_step(model, opt, b)
            losses.append(float(loss))
            if keep_grads:
                step_grads.append({name: t.detach().clone() for name, t in g.items()})
            if k == 0:
                head = dict(grads=_norms(g), logits=logits.cpu(), boxes=boxes.cpu(),
                            assign=assign, batch=b)
        return losses, dict(head, step_grads=step_grads)

    def _late_state(self, model, later: Optional[dict] = None) -> ref.AdamW:
        """``model`` set to the program's copied parameters (a tensor the
        program lacks stays at the seed's value), or where ``later`` has them
        to those, and a reference AdamW with the program's copied moments and
        step count (0 where it has none)."""
        late = self.late_start
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_((later or {}).get(n, late["params"].get(n, p)))
        opt = ref.AdamW(model, self.config["learning_rate"], self.config["weight_decay"])
        for n, _ in opt.params:
            opt.m[n].copy_(late["m"].get(n, opt.m[n]))
            opt.v[n].copy_(late["v"].get(n, opt.v[n]))
        opt.t = late["t"]
        return opt

    def _late_update(self, model, step_grads) -> Dict[str, float]:
        """The change of every trainable parameter that the reference's AdamW
        makes from the program's late state, given each late step's gradients."""
        opt = self._late_state(model)
        start = {n: p.detach().clone() for n, p in opt.params}
        for g in step_grads:
            for n, p in opt.params:
                p.grad = g[n] if n in g else torch.zeros_like(p)
            opt.step()
        return _norms({n: p.detach() - start[n] for n, p in opt.params})

    def reference_readings(self, precision: str = "float32", late_step_grads=None) -> dict:
        """The reference's (or, with ``precision`` "tf32", the control's) first
        steps from the seed's weights, and each late step from the program's
        own parameters before it (the first with the program's AdamW state);
        the late change is what its AdamW makes from the late state with its
        late gradients, and with ``late_step_grads`` also with those
        (``late_update``)."""
        c = self.config
        model = self.reference(precision)
        trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
        start = {n: p.detach().clone() for n, p in trainable.items()}
        opt = ref.AdamW(model, c["learning_rate"], c["weight_decay"])
        losses, head = self._reference_steps(model, opt, 0, CHECKED_STEPS)
        head.pop("step_grads")
        out = dict(losses=losses, change=_norms({n: p.detach() - start[n]
                                                 for n, p in trainable.items()}), **head)
        late = getattr(self, "late_start", None)
        if late is not None:
            late_losses, step_grads = [], []
            for k, later in enumerate([None, *late["later"]]):
                opt = self._late_state(model, later)
                loss, head = self._reference_steps(model, opt, late["i"] + k, 1, keep_grads=True)
                late_losses += loss
                step_grads += head["step_grads"]
                if k == 0:
                    out["late_grads"] = head["grads"]
            out.update(late_losses=late_losses, frozen_moved=0.0, late_step_grads=step_grads,
                       late_change=self._late_update(model, step_grads))
            if late_step_grads is not None:
                out["late_update"] = self._late_update(model, late_step_grads)
        return out

    def check(self, control: Optional[str] = None) -> dict:
        """Against the reference; with ``control`` (a precision), the
        reference in that precision takes the program's place."""
        got = self.reference_readings(control) if control else self.program
        want = self.reference_readings(late_step_grads=got["late_step_grads"])
        counted = moving_leaves(want["grads"])
        late_counted = moving_leaves(want["late_grads"])
        steps = [relative_gap(a, b) for a, b in zip(got["losses"], want["losses"])]
        late_scale = max(abs(want["late_losses"][0]), 1e-30)
        gaps = leaf_gaps(got["grads"], want["grads"], counted)
        grad, grad_leaf = max((g, k) for k, g in gaps.items() if not BOX_BRANCH.search(k))
        box_grad, box_leaf = max((g, k) for k, g in gaps.items() if BOX_BRANCH.search(k))
        change, change_leaf = worst_leaf(got["change"], want["change"], counted)
        late_grad, late_grad_leaf = worst_leaf(got["late_grads"], want["late_grads"], late_counted)
        late_change, late_change_leaf = worst_leaf(got["late_change"], want["late_update"],
                                                   list(want["late_update"]))
        ties = []
        if got["assign"].shape == want["assign"].shape:
            ties = ref.cost_ties(want["logits"], want["boxes"], want["batch"], got["assign"],
                                 want["assign"], TIE_RTOL)
        return dict(
            loss_gap=steps[0],
            logit_gap=scaled_max_gap(got["logits"][-1], want["logits"][-1]),
            box_gap=scaled_max_gap(got["boxes"][-1], want["boxes"][-1]),
            assign_diff=assign_diff(got["assign"], want["assign"], ties),
            grad_gap=grad,
            box_grad_gap=box_grad,
            change_gap=change,
            late_loss_gap=worst(abs(a - b) / late_scale
                                for a, b in zip(got["late_losses"], want["late_losses"])),
            late_grad_gap=median_leaf(got["late_grads"], want["late_grads"], late_counted),
            late_change_gap=late_change,
            frozen_moved=got["frozen_moved"],
            # What the look at a reading needs; no limit holds these.
            loss_gap_by_step=steps, losses=got["losses"], reference_losses=want["losses"],
            late_losses=got["late_losses"], reference_late_losses=want["late_losses"],
            grad_leaf=[grad_leaf, got["grads"].get(grad_leaf), want["grads"][grad_leaf]],
            box_grad_leaf=[box_leaf, got["grads"].get(box_leaf), want["grads"][box_leaf]],
            grad_median=median_leaf(got["grads"], want["grads"], counted),
            change_leaf=[change_leaf, got["change"].get(change_leaf), want["change"][change_leaf]],
            late_grad_worst=[late_grad, late_grad_leaf, got["late_grads"].get(late_grad_leaf),
                             want["late_grads"][late_grad_leaf]],
            late_change_leaf=[late_change_leaf, got["late_change"].get(late_change_leaf),
                              want["late_update"][late_change_leaf]],
            # The change that each side makes from its own late gradients.
            late_change_own_median=median_leaf(got["late_change"], want["late_change"],
                                               late_counted),
            change_median=median_leaf(got["change"], want["change"], counted),
            tied_problems=int(sum(ties)), differing_problems=len(ties),
            gt_boxes=int(ref.ground_truth(want["batch"])[2].sum()),
            leaves_counted=len(counted), leaves=len(want["grads"]))
