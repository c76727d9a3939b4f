"""The port's KGE losses, optimizers and trainer held against the JAX package.

- The three losses, with and without ``adv_temperature``: values and
  gradients against ``jax.grad`` (rtol 1e-6).
- Five trainer steps for each of the four optimizers (SGD, Adam, torch-rule
  Adagrad, Adadelta), with and without weight decay, at both sampling modes,
  on the same injected numpy batches: the JAX side is ``NegativeSampling``
  + ``make_optimizer`` (optax) on those batches, and every parameter agrees
  within 1e-5 of its tensor's largest value after each step.
- The ring-KG memorisation of ``tests/test_kge_end2end.py`` through the
  port's trainer, device sampler and tester (same thresholds), the trainer's
  checkpoint round trip, and ``train_kge --transe-init-epochs``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skghoi_tpu.kge import losses as jlosses
from skghoi_tpu.kge import models as jmodels
from skghoi_tpu.kge.sampling import CorruptBatch as JaxCorruptBatch
from skghoi_tpu.kge.sampling import TripleBatch as JaxTripleBatch
from skghoi_tpu.kge.strategy import NegativeSampling as JaxNegativeSampling
from skghoi_tpu.kge.trainer import make_optimizer as jax_make_optimizer
from skghoi_torch.kge import (DistMult, KGData, MarginLoss, NegativeSampling, SigmoidLoss,
                              SoftplusLoss, Trainer, TransE, TransR, losses, models)
from skghoi_torch.kge import Tester as KGETester
from skghoi_torch.kge.sampling import CorruptBatch, DeviceKG, TripleBatch
from skghoi_torch.tools import train_kge
from skghoi_torch.weights import kge_state_dict

torch.set_num_threads(2)

E, R, B, K, DIM, STEPS = 30, 4, 16, 5, 8, 5


@pytest.mark.parametrize("adv", [None, 0.5, 2.0], ids=["plain", "adv0.5", "adv2"])
@pytest.mark.parametrize("name", ["MarginLoss", "SigmoidLoss", "SoftplusLoss"])
def test_losses(name, adv):
    rng = np.random.default_rng(0)
    p = rng.normal(size=(B, 1)).astype(np.float32) * 3
    n = rng.normal(size=(B, K)).astype(np.float32) * 3
    kw = dict(adv_temperature=adv, **({"margin": 2.0} if name == "MarginLoss" else {}))
    jloss = getattr(jlosses, name)(**kw)
    tloss = getattr(losses, name)(**kw)
    want, (gp, gn) = jax.value_and_grad(lambda a, b: jloss(a, b), argnums=(0, 1))(
        jnp.asarray(p), jnp.asarray(n))
    tp, tn = (torch.tensor(x, requires_grad=True) for x in (p, n))
    got = tloss(tp, tn)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(gn), rtol=1e-6, atol=1e-8)


def _kg(seed=0, n_ent=E, n_rel=R, n_triples=120):
    rng = np.random.default_rng(seed)
    triples = np.stack([rng.integers(0, n_ent, n_triples), rng.integers(0, n_ent, n_triples),
                        rng.integers(0, n_rel, n_triples)], axis=1)
    return KGData.build(n_ent, n_rel, triples)


def _batches(mode, steps=STEPS, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        h, t, r = rng.integers(0, E, B), rng.integers(0, E, B), rng.integers(0, R, B)
        if mode == "oneside":
            out.append(CorruptBatch(h, t, r, rng.integers(0, E, (B, K)),
                                    rng.integers(0, 2, B).astype(bool)))
        else:
            out.append(TripleBatch(h, t, r, rng.integers(0, E, (B, K)), rng.integers(0, E, (B, K)),
                                   np.repeat(r[:, None], K, 1)))
    return out


def _jax_batch(batch):
    if isinstance(batch, CorruptBatch):
        return JaxCorruptBatch(*(jnp.asarray(x, jnp.int32) for x in batch[:4]),
                               jnp.asarray(batch.corrupt_tail))
    return JaxTripleBatch(*(jnp.asarray(x, jnp.int32) for x in batch))


# (optimizer, learning rate); per sampling mode: (model class, kwargs, jax loss, port loss, regul)
OPTIMIZERS = [("sgd", 0.5), ("adam", 1e-2), ("adagrad", 0.5), ("adadelta", 1.0)]
MODES = {
    "normal": ("DistMult", dict(dim=DIM), jlosses.SoftplusLoss(), SoftplusLoss(), 0.1),
    "oneside": ("TransE", dict(dim=DIM, p_norm=1, norm_flag=False, margin=6.0),
                jlosses.SigmoidLoss(adv_temperature=1.0), SigmoidLoss(adv_temperature=1.0), 0.0),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["wd0", "wd1e-2"])
@pytest.mark.parametrize("opt, alpha", OPTIMIZERS, ids=[o for o, _ in OPTIMIZERS])
def test_trainer_steps_match_optax(opt, alpha, weight_decay, mode):
    cls, kw, jloss, tloss, regul = MODES[mode]
    jm = getattr(jmodels, cls)(ent_tot=E, rel_tot=R, **kw)
    z = jnp.zeros((1,), jnp.int32)
    params = jm.init(jax.random.PRNGKey(3), z, z, z)
    tm = getattr(models, cls)(E, R, **kw)
    tm.load_state_dict(kge_state_dict(params))
    batches = _batches(mode)

    init = {k: v.clone() for k, v in tm.state_dict().items()}
    feed = iter(batches)
    trainer = Trainer(tm, NegativeSampling(loss=tloss, regul_rate=regul), DeviceKG.from_kgdata(_kg()),
                      nbatches=1, train_times=STEPS, alpha=alpha, opt_method=opt,
                      weight_decay=weight_decay, sampling_mode=mode, batches=lambda: next(feed),
                      log_fn=lambda s: None)
    jstrat = JaxNegativeSampling(loss=jloss, regul_rate=regul)
    tx = jax_make_optimizer(opt, alpha, weight_decay=weight_decay)
    state = tx.init(params)
    for i, batch in enumerate(batches):
        jl, grads = jax.value_and_grad(lambda p: jstrat(jm, p, _jax_batch(batch)))(params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        loss = trainer.step()
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        want = kge_state_dict(params)
        for n, p in tm.state_dict().items():
            scale = want[n].abs().max().item()
            err = (p - want[n]).abs().max().item()
            assert err <= 1e-5 * scale, (i, n, err, scale)
    assert all(not torch.equal(v, init[k]) for k, v in tm.state_dict().items())


def ring_kg(n_ent=20):
    """All ring edges as train AND test (tests/test_kge_end2end.py::ring_kg)."""
    triples = np.asarray([[i, (i + 1) % n_ent, 0] for i in range(n_ent)], np.int64)
    return KGData.build(n_ent, 1, triples, valid=None, test=triples.copy())


def test_transe_memorizes_ring():
    data = ring_kg()
    model = TransE(data.ent_tot, data.rel_tot, dim=16, p_norm=1, norm_flag=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    Trainer(model, NegativeSampling(loss=MarginLoss(margin=5.0)), DeviceKG.from_kgdata(data),
            nbatches=2, neg_rate=4, bern=False, train_times=300, alpha=0.5, opt_method="sgd",
            log_fn=lambda s: None).run()
    tester = KGETester(model, data, chunk_size=4)
    res = tester.run_link_prediction(log_fn=lambda s: None)
    assert res.hit10 > 0.9, res
    assert res.mr < 4, res
    acc, thr = tester.run_triple_classification()
    assert acc > 0.7, (acc, thr)


def test_distmult_softplus_adagrad_memorizes_ring():
    data = ring_kg()
    model = DistMult(data.ent_tot, data.rel_tot, dim=16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    Trainer(model, NegativeSampling(loss=SoftplusLoss(), regul_rate=1.0), DeviceKG.from_kgdata(data),
            nbatches=2, neg_rate=8, bern=True, train_times=500, alpha=0.5, opt_method="adagrad",
            log_fn=lambda s: None).run()
    res = KGETester(model, data, chunk_size=4).run_link_prediction(log_fn=lambda s: None)
    assert res.hit10 > 0.9, res


def test_transe_sigmoid_adv_oneside_memorizes_ring():
    data = ring_kg()
    model = TransE(data.ent_tot, data.rel_tot, dim=16, p_norm=1, norm_flag=False, margin=6.0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    Trainer(model, NegativeSampling(loss=SigmoidLoss(adv_temperature=1.0)),
            DeviceKG.from_kgdata(data), nbatches=2, neg_rate=8, bern=False, train_times=400,
            alpha=0.05, opt_method="adam", sampling_mode="oneside", log_fn=lambda s: None).run()
    res = KGETester(model, data, chunk_size=4).run_link_prediction(log_fn=lambda s: None)
    assert res.hit10 > 0.9, res


def test_trainer_checkpoint_roundtrip(tmp_path):
    data = ring_kg()
    model = TransE(data.ent_tot, data.rel_tot, dim=8)
    logs = []
    trainer = Trainer(model, NegativeSampling(loss=MarginLoss(margin=1.0)), DeviceKG.from_kgdata(data),
                      nbatches=1, train_times=2, log_fn=logs.append)
    trainer.run()
    assert [line.split(" |")[0] for line in logs] == ["Epoch 0", "Epoch 1"]
    path = str(tmp_path / "kge.ckpt")
    trainer.save_checkpoint(path)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.reset_parameters(torch.Generator().manual_seed(9))
    trainer.load_checkpoint(path)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def write_openke(root, data: KGData):
    """``data`` as OpenKE ``*2id.txt`` files under ``root`` (an empty split
    is left out, as the reader expects)."""
    os.makedirs(root, exist_ok=True)
    for name, n in (("entity2id.txt", data.ent_tot), ("relation2id.txt", data.rel_tot)):
        with open(os.path.join(root, name), "w") as f:
            f.write(f"{n}\n" + "".join(f"e{i}\t{i}\n" for i in range(n)))
    for name, arr in (("train2id.txt", data.train), ("valid2id.txt", data.valid),
                      ("test2id.txt", data.test)):
        if not len(arr):
            continue
        with open(os.path.join(root, name), "w") as f:
            f.write(f"{len(arr)}\n" + "".join(f"{h} {t} {r}\n" for h, t, r in arr))
    return str(root)


def test_train_kge_transe_init_epochs(tmp_path):
    """``--transe-init-epochs`` seeds TransR's entity and relation tables
    with those of a TransE run of the same seed and sampler; the transfer
    matrices stay the identity."""
    root = write_openke(tmp_path / "ring", ring_kg())
    common = ["--data", root, "--device", "cpu", "--dim", "8", "--nbatches", "2",
              "--neg-ent", "3", "--bern", "--skip-eval", "--seed", "4"]
    transr, transe = str(tmp_path / "transr.pt"), str(tmp_path / "transe.pt")
    train_kge.main(common + ["--model", "transr", "--transe-init-epochs", "2", "--epochs", "0",
                             "--checkpoint", transr])
    train_kge.main(common + ["--model", "transe", "--margin", "5.0", "--alpha", "0.5",
                             "--epochs", "2", "--checkpoint", transe])
    got, want = torch.load(transr), torch.load(transe)
    for table in ("ent_embeddings.weight", "rel_embeddings.weight"):
        assert torch.equal(got[table], want[table]), table
    identity = TransR(20, 1, dim_e=8, dim_r=8).transfer_matrix.weight
    assert torch.equal(got["transfer_matrix.weight"], identity)
    assert not torch.equal(got["ent_embeddings.weight"], TransR(20, 1, dim_e=8, dim_r=8)
                           .ent_embeddings.weight)
