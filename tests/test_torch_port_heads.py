"""Port MBF, TransH and masked softmax vs the JAX package, same parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skghoi_tpu.kge.models import TransH as JaxTransH
from skghoi_tpu.models.graph_head import masked_softmax as jax_masked_softmax
from skghoi_tpu.models.mbf import MultiBranchFusion as JaxMBF
from skghoi_torch.kge.models import TransH
from skghoi_torch.models.graph_head import masked_softmax
from skghoi_torch.models.mbf import MultiBranchFusion

torch.set_num_threads(2)


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
                           strict=True)
    return module


@pytest.mark.parametrize("final_relu", [True, False])
def test_mbf_matches(final_relu):
    rng = np.random.default_rng(0)
    app = rng.normal(size=(2, 1, 30, 64)).astype(np.float32)  # broadcast over the pair grid
    spatial = rng.normal(size=(2, 15, 30, 48)).astype(np.float32)
    jmod = JaxMBF(64, 48, 128, 16, final_relu=final_relu)
    params = jmod.init(jax.random.PRNGKey(1), app, spatial)["params"]
    want = jmod.apply({"params": params}, app, spatial)

    port = _load(MultiBranchFusion(64, 48, 128, 16, final_relu=final_relu), params)
    with torch.no_grad():
        got = port(torch.from_numpy(app), torch.from_numpy(spatial))
    assert got.shape == (2, 15, 30, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_transh_score_and_embeddings_match():
    rng = np.random.default_rng(2)
    h = rng.integers(0, 80, (3, 30, 117))
    t = rng.integers(0, 80, (3, 30, 117))
    r = np.broadcast_to(np.arange(117), (3, 30, 117))
    jmod = JaxTransH(ent_tot=80, rel_tot=117, dim=50, p_norm=2, norm_flag=True)
    params = jmod.init(jax.random.PRNGKey(3), h, t, r)["params"]
    want = jmod.apply({"params": params}, h, t, r, method=JaxTransH.score)

    port = TransH(80, 117, dim=50, p_norm=2, norm_flag=True)
    port.load_state_dict({f"{k}.weight": torch.from_numpy(np.array(v["embedding"]))
                          for k, v in params.items()}, strict=True)
    th, tt, tr = (torch.from_numpy(np.ascontiguousarray(x)) for x in (h, t, r))
    with torch.no_grad():
        got = port.score(th, tt, tr)
        emb = port.ent_embeddings(tt[..., 0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(params["ent_embeddings"]["embedding"])[t[..., 0]])


def test_masked_softmax_matches_with_empty_rows():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 15, 30)).astype(np.float32)
    mask = rng.uniform(size=(2, 1, 30)) < 0.6
    mask[1] = False  # fully masked rows must give exact zeros
    got = masked_softmax(torch.from_numpy(logits), torch.from_numpy(mask), dim=2)
    want = jax_masked_softmax(jnp.asarray(logits), jnp.asarray(mask), axis=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert not got[1].any()
