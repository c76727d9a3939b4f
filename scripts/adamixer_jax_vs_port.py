"""AdaMixer's first AdamW steps in the JAX package and in the port, on the CPU.

Full widths (100 queries x 6 stages, content 256, 4 groups, 32/128 points,
FFN 2048, 80 classes), one JAX ``init`` carried into the port through
``weights.adamixer_state_dict``, batch 1: the first image of synthetic
HICO-DET resized into the canvas, with its deduplicated detector GT;
float32, AdamW at ``train_detector``'s defaults (lr 1e-4, weight decay
1e-4).  Each step JAX ``train_adamixer``'s step (``value_and_grad`` of
``set_loss``, optax ``adamw``) and the port's ``build_adamixer_step`` take
the assignments JAX computes from its own forward, as
``test_adamixer_adamw_steps_equal_jax`` feeds them; the port's own
assignments are compared with them.  A float64 copy of the port
(``chip_smoke._float64_copy``) takes the same steps as the reference that
says how far float32 rounding alone carries either package.  Prints one
JSON line a step (the three losses, the float32 ones' distances from each
other and from float64, whether the port's assignments equal JAX's), then
the parameters' largest difference port against JAX and each against
float64 after the last step, in units of the ``STEPS x lr`` that AdamW can
move a parameter.

    JAX_PLATFORMS=cpu python scripts/adamixer_jax_vs_port.py [--canvas H W]

The default canvas is phase 13's, 832x1344; a smaller one scales the
resize's minimum and maximum sizes with it.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from skghoi_torch import constants as C  # noqa: E402
from skghoi_torch.data.factory import DataFactory, HOILoader, to_device  # noqa: E402
from skghoi_torch.data.synthetic import make_synthetic_hicodet  # noqa: E402
from skghoi_torch.detect import adamixer as P  # noqa: E402
from skghoi_torch.tools import train_detector  # noqa: E402
from skghoi_torch.weights import adamixer_state_dict  # noqa: E402
from skghoi_tpu.detect import adamixer as J  # noqa: E402

STEPS = 3
LR = WEIGHT_DECAY = 1e-4


def batch(canvas):
    """Synthetic HICO-DET's first landscape image in ``canvas`` and its GT,
    duplicates masked as ``train_detector`` masks them."""
    scale = canvas[0] / C.CANVAS_LANDSCAPE[0]
    with tempfile.TemporaryDirectory(prefix="skghoi_adamixer_") as root:
        make_synthetic_hicodet(root, "train2015", num_images=1)
        factory = DataFactory("hicodet", "train2015", root,
                              os.path.join(root, "detections_train2015"),
                              min_size=round(C.IMAGE_MIN_SIZE * scale),
                              max_size=round(C.IMAGE_MAX_SIZE * scale), canvas_landscape=canvas)
        hoi = to_device(next(iter(HOILoader(factory, 1, with_targets=True)))[0], "cpu")
    boxes, labels, valid = train_detector.ground_truth(hoi.targets)
    valid = train_detector._first_occurrence_mask(boxes.numpy(), labels.numpy(), valid.numpy())
    return hoi.images.numpy(), boxes.numpy(), labels.numpy(), valid


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--canvas", nargs=2, type=int, default=list(C.CANVAS_LANDSCAPE))
    canvas = tuple(p.parse_args(argv).canvas)
    torch.set_num_threads(4)
    images, boxes, labels, valid = batch(canvas)
    if tuple(images.shape[1:3]) != canvas:
        raise SystemExit(f"batch canvas {images.shape[1:3]}, asked for {canvas}")
    hw = (float(canvas[0]), float(canvas[1]))
    t0 = time.perf_counter()

    model = J.AdaMixerDetector(num_classes=C.HICO_NUM_OBJECTS)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(images)))
    params, extra = variables["params"], {k: v for k, v in variables.items() if k != "params"}
    tx = optax.adamw(LR, weight_decay=WEIGHT_DECAY)
    opt_state = tx.init(params)
    jargs = tuple(map(jnp.asarray, (images, boxes, labels, valid)))
    forward = jax.jit(lambda p: model.apply({"params": p, **extra}, jargs[0]))

    @jax.jit
    def jax_step(params, opt_state, assignments):  # train_adamixer's step
        def loss_fn(p):
            out = model.apply({"params": p, **extra}, jargs[0])
            return J.set_loss(out, assignments, *jargs[1:], hw)["set_loss"]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    port = P.AdaMixerDetector(num_classes=C.HICO_NUM_OBJECTS, device="cpu")
    port.load_state_dict(adamixer_state_dict(variables), strict=True)
    port64 = chip_smoke._float64_copy(port)
    steps = [train_detector.build_adamixer_step(m, train_detector.adamw(m, LR, WEIGHT_DECAY))
             for m in (port, port64)]
    own_assignments = P.compute_assignments
    tensors = tuple(map(torch.from_numpy, (images, boxes, labels, valid)))
    tensors64 = (tensors[0], tensors[1].double(), *tensors[2:])
    for i in range(STEPS):
        shared = np.asarray(J.compute_assignments(forward(params), *jargs[1:], hw))
        params, opt_state, want = jax_step(params, opt_state, jnp.asarray(shared))
        same = []

        def fed(*args):
            same.append(bool(np.array_equal(own_assignments(*args), shared)))
            return shared

        with mock.patch.object(P, "compute_assignments", fed):
            got = steps[0](*tensors)["set_loss"].item()
        with mock.patch.object(P, "compute_assignments", lambda *args: shared):
            exact = steps[1](*tensors64)["set_loss"].item()
        want = float(want)
        print(json.dumps(dict(step=i + 1, jax_set_loss=want, port_set_loss=got,
                              port_float64_set_loss=exact, port_vs_jax=abs(got - want) / abs(want),
                              jax_vs_float64=abs(want - exact) / abs(exact),
                              port_vs_float64=abs(got - exact) / abs(exact),
                              port_assignments_equal=same[0])), flush=True)

    jax_sd = adamixer_state_dict({"params": jax.tree_util.tree_map(np.asarray, params)})
    f32, f64 = dict(port.named_parameters()), dict(port64.named_parameters())

    def farthest(a, b):
        d = {n: (a[n].detach().double() - b[n].detach().double()).abs().max().item() / (STEPS * LR)
             for n in f32}
        worst = max(d, key=d.get)
        return [d[worst], worst]

    print(json.dumps(dict(canvas=list(canvas), gt_boxes=int(valid.sum()), steps=STEPS,
                          params_port_vs_jax=farthest(f32, jax_sd),
                          params_jax_vs_float64=farthest(jax_sd, f64),
                          params_port_vs_float64=farthest(f32, f64),
                          seconds=time.perf_counter() - t0)))


if __name__ == "__main__":
    main()
