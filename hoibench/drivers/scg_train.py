"""SCG training, closed loop, one process: each step takes a collated numpy
batch from the pool through the program's ``data.factory.to_device`` and the
step of ``parallel.train_step.build_train_step`` (two-group AdamW with the
NaN guard), with the TransH noise drawn as ``train.engine`` draws it, and
reads the losses back, as ``train_hicodet`` does.

Set-up builds the one step object, drives it through its first steps on
the pool's first batches (all different), keeping for the check the losses
of steps 1-3, the first gradient as AdamW holds it after step 1 (its first
moment over 1 - beta1) and the change of every parameter after step 3; then
it warms every canvas of the pool twice.  The window goes on with the same
object.  Once the window (and the traced steps) are over, ``release``
copies that object's parameters and AdamW state and drives it through two
more steps of the window's own call, keeping their losses, the gradient of
the first (from AdamW's moments before and after it) and the change of
every parameter over the two; and it reads every tensor the reference
keeps frozen (the stem, ``layer1``, every frozen BatchNorm term) against
the seed's.

The check runs the reference's first three steps from the seed's weights,
and its two late steps from the copied parameters and AdamW state, on the
same batches and noise, after the program is freed.  Its numbers:
``loss_gap`` (step 1's relative loss difference: the loss falls up to
tenfold a step and AdamW's first updates are about lr x sign(g), so steps 2
and 3 differ by which entries bfloat16 rounds across zero; their gaps are
read beside it), ``grad_gap`` and ``change_gap`` (worst leaf's norm against
the reference's norm of that leaf or of the median leaf, whichever is
larger; leaves whose reference gradient is under a thousandth of the
median leaf's are left out, since they move by round-off alone),
``late_loss_gap`` (the late steps' worst loss difference over the first
late loss), ``late_grad_gap`` and ``late_change_gap`` (the median leaf's gap
of the first late gradient and of the change over the late steps, by the
same measure: the worst leaf's swings from seed to seed once the loss has
fallen a hundredfold, and is read beside them), ``filter_slots`` (slots of
step 1's filter that differ) and ``frozen_moved`` (the largest change of a
frozen tensor over the whole run).
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch

from hoibench.checks import median_leaf, moving_leaves, relative_gap, worst, worst_leaf
from hoibench.drivers.common import SCGCell, as_hoibatch, reference_batch, sync
from hoibench.reference import scg as ref
from hoibench.trace import span
from hoibench.weights import sub_seed
from skghoi_torch.data.factory import to_device
from skghoi_torch.models.graph_head import gumbel_noise
from skghoi_torch.parallel.train_step import build_train_step
from skghoi_torch.train.optimizer import build_optimizer

CHECKED_STEPS = 3
LATE_STEPS = 2
BETA1 = 0.9


def _norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    names = list(tensors)
    values = torch.stack([t.detach().float().norm() for t in tensors.values()]) * scale
    return dict(zip(names, values.tolist()))


def _moments(model, opt, key: str) -> Dict[str, torch.Tensor]:
    """AdamW's ``key`` moment of every trainable parameter, by name (zeros
    where AdamW holds none yet)."""
    return {n: opt.state[p][key] if key in opt.state.get(p, {}) else torch.zeros_like(p)
            for n, p in model.named_parameters() if p.requires_grad}


def _filter_slots(a: dict, b: dict) -> int:
    """Slots whose box or label differ, plus the count differences; every
    slot where the shapes differ."""
    if a["boxes"].shape != b["boxes"].shape:
        return b["labels"].numel() + 2 * b["n"].numel()
    boxes = (a["boxes"] != b["boxes"]).any(-1) | (a["labels"] != b["labels"])
    return int(boxes.sum() + (a["n_h"] != b["n_h"]).sum() + (a["n"] != b["n"]).sum())


class Driver(SCGCell):
    def setup(self) -> None:
        self.make_inputs()
        self.build_kernel()
        model = self.program_model()
        cfg = self.config
        opt = build_optimizer(model, learning_rate=cfg["learning_rate"],
                              lr_decay=cfg["lr_decay_backbone"], weight_decay=cfg["weight_decay"],
                              steps_per_epoch=cfg["steps_per_epoch"],
                              milestones=(cfg["lr_milestone_epoch"],),
                              milestone_gamma=cfg["lr_gamma"])
        self.model, self.opt = model, opt
        self.step = build_train_step(model, opt, self.ovm())
        self.gumbel = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "gumbel"))
        self.i = self.applied = 0
        self.program = self._first_steps(model, opt)
        seen: Dict[tuple, int] = {}
        while min(seen.values(), default=0) < 2 or len(seen) < len(self.traffic["canvases"]):
            canvas = self.pool[self.i % len(self.pool)]["images"].shape[1:3]
            seen[canvas] = seen.get(canvas, 0) + 1
            self._step()
        sync(self.device)

    def _step(self):
        b = self.pool[self.i % len(self.pool)]
        self.i += 1
        with span("to_device"):
            batch = to_device(as_hoibatch(b), self.device)
        with span("noise"):
            noise = gumbel_noise((len(b["images"]), self.noise_cols), self.gumbel, self.device)
        with span("train_step"):
            total, losses, out, applied = self.step(batch, gumbel=noise)
        with span("read_losses"):
            values = torch.stack([total, *losses.values()]).tolist()
        self.applied += bool(applied)
        return values, out, applied

    @property
    def noise_cols(self) -> int:
        return ref.MAX_HUMAN * (ref.MAX_HUMAN + ref.MAX_OBJECT) * ref.N_VERBS

    def _first_steps(self, model, opt) -> dict:
        trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
        start = {n: p.detach().clone() for n, p in trainable.items()}
        losses, grads, first = [], {}, None
        for k in range(CHECKED_STEPS):
            values, out, applied = self._step()
            losses.append(values[0])
            if k == 0:
                first = dict(boxes=out.boxes.cpu(), labels=out.object_class.cpu(),
                             n_h=out.n_h.cpu(), n=out.n.cpu())
                grads = _norms(_moments(model, opt, "exp_avg"), 1.0 / (1.0 - BETA1))
        change = _norms({n: p.detach() - start[n] for n, p in trainable.items()})
        return dict(losses=losses, grads=grads, change=change, filter=first)

    def window(self, seconds: float) -> dict:
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            _, _, applied = self._step()
            self.attempted += 1
            self.failed += not applied
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        self.unit_s = elapsed / self.attempted
        return {"train_img_per_s": self.attempted * self.traffic["batch"] / elapsed}

    def run_units(self, n: int) -> None:
        self.traced_inputs = []
        for _ in range(n):
            b = self.pool[self.i % len(self.pool)]
            with span("step"):
                _, out, _ = self._step()
            shapes = self.map_shapes(b["images"].shape[1:3], len(b["images"]))
            self.traced_inputs.append((shapes, out.boxes.detach().clone()))

    def release(self) -> None:
        """Copy the timed step object's state, drive it through the late
        steps, read the frozen tensors, and free the program."""
        model, opt = self.model, self.opt
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        m0, v0 = ({n: t.clone() for n, t in _moments(model, opt, key).items()}
                  for key in ("exp_avg", "exp_avg_sq"))
        self.late_start = dict(i=self.i, t=self.applied, gumbel=self.gumbel.get_state(),
                               params=params, m=m0, v=v0)
        losses, grads = [], {}
        for k in range(LATE_STEPS):
            values, _, _ = self._step()
            losses.append(values[0])
            if k == 0:
                m1 = _moments(model, opt, "exp_avg")
                grads = _norms({n: m1[n] - BETA1 * m0[n] for n in m1}, 1.0 / (1.0 - BETA1))
        change = _norms({n: p.detach() - params[n] for n, p in model.named_parameters()})
        self.program.update(late_losses=losses, late_grads=grads, late_change=change,
                            frozen_moved=self._frozen_moved(model.state_dict()))
        self.step = self.model = self.opt = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _frozen_moved(self, state: Dict[str, torch.Tensor]) -> float:
        """The largest change from the seed's value of any tensor that the
        reference keeps frozen: its buffers and the parameters it gives no
        gradient; one the program lacks or reshapes reads infinite."""
        meta = self.reference_model(device="meta")
        frozen = [n for n, p in meta.named_parameters() if not p.requires_grad]
        frozen += [n for n, _ in meta.named_buffers()]
        seed = self.state()
        moved = 0.0
        for n in frozen:
            got = state.get(n)
            if got is None or got.shape != seed[n].shape:
                return math.inf
            moved = max(moved, float((got.float() - seed[n]).abs().max()))
        return moved

    def flop_fn(self, canvas):
        """The reference's forward and backward of one step at ``canvas``, on meta tensors."""
        b = next(p for p in self.pool if p["images"].shape[1:3] == tuple(canvas))

        def run():
            model = self.reference_model(device="meta")
            batch = {k: torch.empty(v.shape, dtype=torch.int64 if v.dtype.kind == "i" else
                                    torch.bool if v.dtype.kind == "b" else torch.float32,
                                    device="meta") for k, v in b.items()}
            noise = torch.empty((len(b["images"]), self.noise_cols), device="meta")
            out = model(batch, torch.empty(self.ovm_np.shape, device="meta"), noise)
            sum(out["losses"].values()).backward()

        return run

    def _reference_opt(self, model) -> "ref.AdamW":
        c = self.config
        return ref.AdamW(model, c["learning_rate"], c["lr_decay_backbone"], c["weight_decay"],
                         c["steps_per_epoch"] * c["lr_milestone_epoch"], c["lr_gamma"])

    def _reference_steps(self, model, opt, first: int, gen, n: int):
        """``n`` reference steps on the pool's batches from ``first``: their
        losses, the first step's gradients and filter slots."""
        losses, grads, slots = [], {}, None
        for k in range(n):
            b = self.pool[(first + k) % len(self.pool)]
            noise = ref.gumbel_noise((len(b["images"]), self.noise_cols), gen, self.device)
            total, _, g, _, s = ref.train_step(model, opt, reference_batch(b, self.device),
                                               self.ovm(), noise)
            losses.append(float(total))
            if k == 0:
                grads, slots = _norms(g), {key: v.cpu() for key, v in s.items()}
        return losses, grads, slots

    def reference_readings(self, precision: str = "float32") -> dict:
        """The reference's (or, with a lower ``precision``, the control's)
        first steps from the seed's weights, and its late steps from the
        program's copied parameters and AdamW state."""
        model = self.reference(precision)
        trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
        start = {n: p.detach().clone() for n, p in trainable.items()}
        opt = self._reference_opt(model)
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, "gumbel"))
        losses, grads, first = self._reference_steps(model, opt, 0, gen, CHECKED_STEPS)
        change = _norms({n: p.detach() - start[n] for n, p in trainable.items()})
        out = dict(losses=losses, grads=grads, change=change, filter=first)
        late = getattr(self, "late_start", None)
        if late is not None:
            # A tensor the program lacks stays at the seed's value (and 0 in AdamW).
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(late["params"].get(n, p))
            opt = self._reference_opt(model)
            for n, _ in opt.params:
                opt.m[n].copy_(late["m"].get(n, opt.m[n]))
                opt.v[n].copy_(late["v"].get(n, opt.v[n]))
            opt.t = late["t"]
            gen = torch.Generator(device=self.device)
            gen.set_state(late["gumbel"])
            start = {n: p.detach().clone() for n, p in trainable.items()}
            losses, grads, _ = self._reference_steps(model, opt, late["i"], gen, LATE_STEPS)
            out.update(late_losses=losses, late_grads=grads, frozen_moved=0.0,
                       late_change=_norms({n: p.detach() - start[n] for n, p in trainable.items()}))
        return out

    def check(self, control: Optional[str] = None) -> dict:
        """Against the reference; with ``control`` (a precision), the
        reference in that precision takes the program's place."""
        want = self.reference_readings()
        got = self.reference_readings(control) if control else self.program
        counted = moving_leaves(want["grads"])
        late_counted = moving_leaves(want["late_grads"])
        steps = [relative_gap(a, b) for a, b in zip(got["losses"], want["losses"])]
        late_scale = max(abs(want["late_losses"][0]), 1e-30)
        grad, grad_leaf = worst_leaf(got["grads"], want["grads"], counted)
        change, change_leaf = worst_leaf(got["change"], want["change"], counted)
        late_grad, late_grad_leaf = worst_leaf(got["late_grads"], want["late_grads"], late_counted)
        late_change, late_change_leaf = worst_leaf(got["late_change"], want["late_change"], late_counted)
        return dict(
            loss_gap=steps[0], grad_gap=grad, change_gap=change,
            late_loss_gap=worst(abs(a - b) / late_scale
                                for a, b in zip(got["late_losses"], want["late_losses"])),
            late_grad_gap=median_leaf(got["late_grads"], want["late_grads"], late_counted),
            late_change_gap=median_leaf(got["late_change"], want["late_change"], late_counted),
            filter_slots=_filter_slots(got["filter"], want["filter"]),
            frozen_moved=got["frozen_moved"],
            # What the look at a reading needs; no limit holds these.
            loss_gap_by_step=steps, losses=got["losses"], reference_losses=want["losses"],
            late_losses=got["late_losses"], reference_late_losses=want["late_losses"],
            grad_leaf=[grad_leaf, got["grads"].get(grad_leaf), want["grads"][grad_leaf]],
            change_leaf=[change_leaf, got["change"].get(change_leaf), want["change"][change_leaf]],
            late_grad_worst=[late_grad, late_grad_leaf, got["late_grads"].get(late_grad_leaf),
                             want["late_grads"][late_grad_leaf]],
            late_change_worst=[late_change, late_change_leaf],
            leaves_counted=len(counted), leaves=len(want["grads"]))
