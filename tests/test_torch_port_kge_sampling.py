"""The port's KGE data reader and negative samplers held against the JAX package.

- ``KGData.load`` (duplicated train triples, valid/test, type constraints)
  gives arrays equal to JAX's exactly, ``bern_tail_prob`` included.
- ``TripleSet.contains`` equals JAX's ``TripleHashSet.contains`` and the
  exact set on every query of the full (h, r, t) grid.
- The device samplers (both sampling modes, filtered): shapes and dtypes,
  positives are train triples, exactly one side corrupted, no known negative
  on a graph where JAX's sampler returns none either, and only known ones
  where no unknown corruption exists (the 4 rejection rounds cannot help,
  in either package); the corrupted side's frequency per relation within a
  5-sigma binomial bound of the Bernoulli (or 1/2) probability.
- ``NumpySampler`` draws the same batches as JAX's from the same seed.
"""

import jax
import numpy as np
import pytest
import torch

from skghoi_tpu.kge.data import KGData as JaxKGData
from skghoi_tpu.kge.sampling import DeviceKG as JaxDeviceKG
from skghoi_tpu.kge.sampling import NumpySampler as JaxNumpySampler
from skghoi_tpu.kge.sampling import TripleHashSet
from skghoi_tpu.kge.sampling import sample_batch as jax_sample_batch
from skghoi_tpu.kge.sampling import sample_batch_oneside as jax_sample_batch_oneside
from skghoi_torch.kge.data import KGData
from skghoi_torch.kge.sampling import (CorruptBatch, DeviceKG, NumpySampler, TripleBatch, TripleSet,
                                       sample_batch, sample_batch_oneside)

torch.set_num_threads(2)


def make_kg(cls=KGData, seed=0, n_ent=40, n_rel=5, n_triples=200):
    """tests/test_kge_sampling.py::make_kg, for either package's KGData."""
    rng = np.random.default_rng(seed)
    triples = np.stack([rng.integers(0, n_ent, n_triples), rng.integers(0, n_ent, n_triples),
                        rng.integers(0, n_rel, n_triples)], axis=1)
    return cls.build(n_ent, n_rel, triples)


def test_kgdata_load_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    n_ent, n_rel = 50, 6
    triples = np.stack([rng.integers(0, n_ent, 300), rng.integers(0, n_ent, 300),
                        rng.integers(0, n_rel, 300)], axis=1)
    train = np.concatenate([triples[:240], triples[:20]])  # duplicates the reader drops
    for name, n in (("entity2id.txt", n_ent), ("relation2id.txt", n_rel)):
        (tmp_path / name).write_text(f"{n}\n")
    for name, arr in (("train2id.txt", train), ("valid2id.txt", triples[240:270]),
                      ("test2id.txt", triples[270:])):
        (tmp_path / name).write_text(f"{len(arr)}\n" + "".join(f"{h} {t} {r}\n" for h, t, r in arr))
    lines = [f"{n_rel}"]
    for r in range(n_rel - 1):  # the last relation has no constraint line
        for col in (0, 1):
            ents = sorted(set(train[train[:, 2] == r, col].tolist()))
            lines.append(f"{r} {len(ents)} " + " ".join(map(str, ents)))
    lines += [f"{n_rel - 1} 0", f"{n_rel - 1} 0"]
    (tmp_path / "type_constrain.txt").write_text("\n".join(lines) + "\n")

    got = KGData.load(str(tmp_path), with_type_constrain=True)
    want = JaxKGData.load(str(tmp_path), with_type_constrain=True)
    assert (got.ent_tot, got.rel_tot, got.train_total) == (want.ent_tot, want.rel_tot,
                                                           want.train_total)
    assert got.train_total <= 240 < len(train)
    for name in ("train", "valid", "test", "left_mean", "right_mean", "train_keys", "all_keys"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(got.bern_tail_prob(), want.bern_tail_prob())
    for name in ("head_type", "tail_type"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a), name


def test_membership_equals_hashset_on_grid():
    data = make_kg(n_ent=25, n_triples=300)
    h, t, r = data.train[:, 0], data.train[:, 1], data.train[:, 2]
    hashset = TripleHashSet(h, r, t)
    known = TripleSet(h, r, t, data.rel_tot, data.ent_tot)
    qh, qr, qt = (x.ravel() for x in np.meshgrid(np.arange(data.ent_tot), np.arange(data.rel_tot),
                                                np.arange(data.ent_tot), indexing="ij"))
    got = known.contains(*(torch.from_numpy(x) for x in (qh, qr, qt))).numpy()
    want = np.asarray(hashset.contains(*(jax.numpy.asarray(x, jax.numpy.int32)
                                         for x in (qh, qr, qt))))
    exact = np.isin(data.encode(qh, qt, qr), data.train_keys)
    assert got.sum() == len(data.train) and np.array_equal(got, exact)
    assert np.array_equal(got, want)


def _sample(mode, kg, g, batch_size, neg_rate, bern):
    fn = sample_batch_oneside if mode == "oneside" else sample_batch
    return fn(g, kg, batch_size, neg_rate, bern=bern)


def _negatives(batch):
    """(h, t, r) numpy grids of a batch's negatives, either kind."""
    if hasattr(batch, "neg_ent"):  # either package's CorruptBatch
        ct = np.asarray(batch.corrupt_tail)[:, None]
        ph, pt, pr = (np.asarray(x)[:, None] for x in batch[:3])
        ne = np.asarray(batch.neg_ent)
        return np.where(ct, ph, ne), np.where(ct, ne, pt), np.broadcast_to(pr, ne.shape)
    return tuple(np.asarray(x) for x in (batch.neg_h, batch.neg_t, batch.neg_r))


def _known_share(data, batch):
    nh, nt, nr = _negatives(batch)
    return float(np.isin(data.encode(nh, nt, nr), data.train_keys).mean())


@pytest.mark.parametrize("mode", ["normal", "oneside"])
def test_shapes_positives_and_one_side(mode):
    data = make_kg()
    kg = DeviceKG.from_kgdata(data)
    g = torch.Generator().manual_seed(0)
    batch = _sample(mode, kg, g, 64, 8, bern=True)
    assert isinstance(batch, CorruptBatch if mode == "oneside" else TripleBatch)
    for name, x in zip(batch._fields, batch):
        shape = (64,) if name.startswith("pos") or name == "corrupt_tail" else (64, 8)
        assert tuple(x.shape) == shape, name
        assert x.dtype == (torch.bool if name == "corrupt_tail" else torch.int64), name
    pos = data.encode(*(batch[i].numpy() for i in (0, 1, 2)))
    assert np.isin(pos, data.train_keys).all()
    nh, nt, nr = _negatives(batch)
    ph, pt = batch.pos_h.numpy()[:, None], batch.pos_t.numpy()[:, None]
    assert ((nh == ph) | (nt == pt)).all() and (nr == batch.pos_r.numpy()[:, None]).all()
    assert nh.min() >= 0 and max(nh.max(), nt.max()) < data.ent_tot


@pytest.mark.parametrize("mode", ["normal", "oneside"])
def test_no_known_negative_where_jax_has_none(mode):
    """On the sparse graph neither sampler emits a known negative; on a
    saturated graph (every (h, t) pair known for the only relation) no
    unknown corruption exists, and both emit only known ones."""
    jax_fn = jax_sample_batch_oneside if mode == "oneside" else jax_sample_batch
    for dense, want_share in ((False, 0.0), (True, 1.0)):
        if dense:
            pairs = np.stack(np.meshgrid(np.arange(6), np.arange(6), indexing="ij"), -1).reshape(-1, 2)
            triples = np.concatenate([pairs, np.zeros((36, 1), np.int64)], 1)
            data, jdata = KGData.build(6, 1, triples), JaxKGData.build(6, 1, triples)
        else:
            data, jdata = make_kg(), make_kg(JaxKGData)
        kg, jkg = DeviceKG.from_kgdata(data), JaxDeviceKG.from_kgdata(jdata)
        g = torch.Generator().manual_seed(1)
        for i in range(4):
            jbatch = jax_fn(jax.random.PRNGKey(i), jkg, 64, 8, bern=True)
            assert _known_share(data, jbatch) == want_share
            assert _known_share(data, _sample(mode, kg, g, 64, 8, bern=True)) == want_share


@pytest.mark.parametrize("bern", [True, False], ids=["bern", "uniform"])
@pytest.mark.parametrize("mode", ["normal", "oneside"])
def test_corruption_side_frequencies(mode, bern):
    data = make_kg(n_rel=4)
    kg = DeviceKG.from_kgdata(data)
    g = torch.Generator().manual_seed(2)
    p_tail = data.bern_tail_prob() if bern else np.full(data.rel_tot, 0.5, np.float32)
    tails = np.zeros(data.rel_tot)
    counts = np.zeros(data.rel_tot)
    for _ in range(10):
        batch = _sample(mode, kg, g, 512, 8, bern)
        r = batch.pos_r.numpy()
        if mode == "oneside":
            side, rel = batch.corrupt_tail.numpy(), r
        else:  # a negative that keeps the positive's head corrupts the tail
            side = batch.neg_h.numpy() == batch.pos_h.numpy()[:, None]
            rel = np.broadcast_to(r[:, None], side.shape)
        np.add.at(tails, rel.ravel(), side.ravel())
        np.add.at(counts, rel.ravel(), 1)
    assert (counts > 500).all() and len(np.unique(p_tail)) > (1 if bern else 0)
    sigma = np.sqrt(p_tail * (1 - p_tail) / counts)
    assert (np.abs(tails / counts - p_tail) <= 5 * sigma + 1e-12).all(), (tails / counts, p_tail)


def test_bern_tail_prob_on_device_equals_jax():
    data, jdata = make_kg(), make_kg(JaxKGData)
    assert np.array_equal(DeviceKG.from_kgdata(data).bern_tail_prob.numpy(),
                          np.asarray(JaxDeviceKG.from_kgdata(jdata).bern_tail_prob))
    assert np.array_equal(data.bern_tail_prob(), jdata.bern_tail_prob())


@pytest.mark.parametrize("bern", [True, False], ids=["bern", "uniform"])
def test_numpy_sampler_equals_jax(bern):
    data, jdata = make_kg(n_ent=15, n_triples=150), make_kg(JaxKGData, n_ent=15, n_triples=150)
    got = NumpySampler(data, seed=3).sample(batch_size=128, neg_rate=4, bern=bern)
    want = JaxNumpySampler(jdata, seed=3).sample(batch_size=128, neg_rate=4, bern=bern)
    for name, a, b in zip(got._fields, got, want):
        assert np.array_equal(a, b), name
    assert _known_share(data, got) == 0.0
