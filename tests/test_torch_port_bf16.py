"""The port's bfloat16 SCG eval forward held against the JAX package's.

bfloat16 is the dtype the card serves in (``chip_smoke.py`` phase 4).  One
JAX initialisation of the full-width network (64x96 canvas, batch 2) is
loaded into both packages, and both run the eval forward in bfloat16:

- ``boxes``, ``n_h``, ``n``, ``object_class`` and ``pair_valid`` equal (the
  detection filter runs in float32 in both);
- scores within 1e-2 and ``weights`` within 1.5e-2 (absolute).  Measured at
  this seed on the CPU: 4.49e-3 for the scores and 7.8e-3 for ``weights``,
  inside each package's own bfloat16-against-float32 gap (5.20e-3 for the
  port's scores, 6.54e-3 for JAX's): two roundings of bfloat16's 8-bit
  mantissa through ResNet-50, the FPN and the heads, in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from skghoi_tpu.models import SpatiallyConditionedGraph as JaxSCG
from skghoi_torch.entry import build_model, make_batch, verb_mask
from skghoi_torch.weights import to_state_dict

torch.set_num_threads(2)

CANVAS = (64, 96)


@pytest.fixture(scope="module")
def outputs():
    batch = graft._make_batch(2, CANVAS)
    ovm = graft._verb_mask()
    jmodel = JaxSCG(dtype=jnp.bfloat16)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, b: jmodel.init(r, b, ovm, training=False))(jax.random.PRNGKey(0), batch))
    want = jax.jit(lambda v, b: jmodel.apply(v, b, ovm, training=False))(variables, batch)
    model = build_model(dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = model(make_batch(2, CANVAS, device="cpu"), verb_mask(device="cpu"))
    return got, want


def test_bf16_filtered_detections_equal(outputs):
    got, want = outputs
    for name in ("boxes", "n_h", "n", "object_class", "pair_valid"):
        np.testing.assert_array_equal(getattr(got, name).float().numpy(),
                                      np.asarray(getattr(want, name), np.float32), err_msg=name)


@pytest.mark.parametrize("name,tol", [("scores", 1e-2), ("weights", 1.5e-2)])
def test_bf16_scores_within_tolerance(outputs, name, tol):
    got, want = outputs
    g = getattr(got, name).float().numpy()
    w = np.asarray(getattr(want, name), np.float32)
    assert g.shape == w.shape and np.abs(w).max() > 0
    assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max())
