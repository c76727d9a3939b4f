"""The port's HICO-DET data pipeline held against the JAX package's, on the CPU.

The synthetic files byte for byte; the dataset's lookup tables; every
``DataFactory`` sample (random flips, seed 1) and every collated batch equal
to JAX's; ``HOILoader`` batch order, orientation buckets, short-batch
padding and sharding equal; the threaded loader equal to the synchronous
one; ``device_resize_canvas`` against JAX's (atol 1e-6) and against the host
``prepare_image`` (atol 2e-5, the JAX suite's); ``resize_boxes`` and
``hflip_boxes`` against ``skghoi_tpu.ops.boxes`` (1e-6); ``to_device``.
"""

import os
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from skghoi_tpu.data import factory as jfactory
from skghoi_tpu.data import synthetic as jsynthetic
from skghoi_tpu.data.device_preprocess import device_resize_canvas as jax_device_resize
from skghoi_tpu.data.hicodet import HICODet as JaxHICODet
from skghoi_tpu.data.transforms import prepare_image as jax_prepare_image
from skghoi_tpu.ops import boxes as jboxes
from skghoi_torch import constants as C
from skghoi_torch.data import factory, synthetic
from skghoi_torch.data.device_preprocess import device_resize_canvas, prepare_batch
from skghoi_torch.data.hicodet import HICODet
from skghoi_torch.data.transforms import prepare_image, resize_scale, resized_size
from skghoi_torch.ops.boxes import hflip_boxes, resize_boxes

torch.set_num_threads(2)

SMALL = dict(min_size=64, max_size=107, canvas_landscape=(64, 96), canvas_portrait=(96, 64))
SAMPLE_KEYS = ("image", "image_size", "original_size", "det_boxes", "det_labels", "det_scores",
               "gt_boxes_h", "gt_boxes_o", "gt_object", "gt_labels")


def _files(root):
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same synthetic HICO-DET written by both packages: a landscape
    train split and a portrait test split."""
    out = {}
    try:
        for name, make in (("jax", jsynthetic.make_synthetic_hicodet),
                           ("port", synthetic.make_synthetic_hicodet)):
            out[name] = root = str(tmp_path_factory.mktemp(f"synth_{name}"))
            make(root, "train2015", num_images=6, seed=3)
            make(root, "test2015", num_images=5, image_size=(150, 110), seed=4)
        yield out
    finally:
        for root in out.values():
            shutil.rmtree(root, ignore_errors=True)


def _factories(roots, partition="train2015", **kw):
    def det(root):
        return os.path.join(root, f"detections_{partition}")

    j = jfactory.DataFactory("hicodet", partition, roots["jax"], det(roots["jax"]), **SMALL, **kw)
    p = factory.DataFactory("hicodet", partition, roots["port"], det(roots["port"]), **SMALL, **kw)
    return j, p


def test_synthetic_hicodet_files_byte_for_byte(roots):
    want, got = _files(roots["jax"]), _files(roots["port"])
    assert sorted(got) == sorted(want) and len(got) == 2 + 2 * (6 + 5)
    for name in want:
        assert got[name] == want[name], name


def test_synthetic_vcoco_files_byte_for_byte(tmp_path):
    jsynthetic.make_synthetic_vcoco(str(tmp_path / "jax"), "test", num_images=3, seed=2)
    synthetic.make_synthetic_vcoco(str(tmp_path / "port"), "test", num_images=3, seed=2)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert got.keys() == want.keys() and len(got) == 7
    assert all(got[k] == want[k] for k in want)


@pytest.mark.parametrize("partition", ["train2015", "test2015"])
def test_hicodet_lookup_tables_equal(roots, partition):
    def load(cls, root):
        return cls(os.path.join(root, "hico_20160224_det/images", partition),
                   os.path.join(root, f"instances_{partition}.json"))

    j, p = load(JaxHICODet, roots["jax"]), load(HICODet, roots["port"])
    assert len(j) == len(p) > 0
    for name in ("object_n_verb_to_interaction", "anno_interaction", "object_to_interaction",
                 "object_to_verb", "anno_object", "anno_action", "class_corr", "interactions"):
        assert getattr(p, name) == getattr(j, name), name
    np.testing.assert_array_equal(p.object_verb_mask(), j.object_verb_mask())
    jsub, psub = j.split(0.5, seed=1), p.split(0.5, seed=1)
    for a, b in zip(jsub, psub):
        assert b.pool == a.pool and b.anno_interaction == a.anno_interaction
    image = p.load_image(os.path.join(roots["port"], "hico_20160224_det/images", partition,
                                      p.filename(0)))
    assert image.dtype == np.uint8 and image.shape == (*p.image_size(0)[::-1], 3)
    np.testing.assert_array_equal(image, np.asarray(j[0][0]))


@pytest.mark.parametrize("partition", ["train2015", "test2015"])
def test_factory_samples_equal(roots, partition):
    jf, pf = _factories(roots, partition, flip=True, seed=1)
    np.testing.assert_array_equal(pf._flip, jf._flip)
    assert pf._flip.any() and not pf._flip.all(), "flip and no flip must both be covered"
    for i in range(len(jf)):
        want, got = jf[i], pf[i]
        assert got["canvas"] == want["canvas"] and got["index"] == want["index"] == i
        for key in SAMPLE_KEYS:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{i} {key}")


def test_factory_device_resize_samples_equal(roots):
    kw = dict(device_resize=True, raw_canvas_landscape=(128, 160),
              raw_canvas_portrait=(160, 128), flip=True, seed=1)
    jf, pf = _factories(roots, **kw)
    for i in range(len(jf)):
        want, got = jf[i], pf[i]
        assert got["image"].dtype == np.uint8 and got["image"].shape == (128, 160, 3)
        for key in SAMPLE_KEYS:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{i} {key}")


@pytest.mark.parametrize("with_targets", [True, False])
def test_collate_equal(roots, with_targets):
    jf, pf = _factories(roots, flip=True, seed=1)
    idx = [0, 2, 3]
    want = jfactory.collate([jf[i] for i in idx], with_targets=with_targets)
    got = factory.collate([pf[i] for i in idx], with_targets=with_targets)
    assert got.det_boxes.shape == (3, C.MAX_RAW_DETECTIONS, 4)
    for name, a, b in zip(got._fields[:-1], got[:-1], want[:-1]):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.targets is None) == (not with_targets)
    if with_targets:
        assert got.targets.valid.shape == (3, C.MAX_GT_PAIRS)
        for name, a, b in zip(got.targets._fields, got.targets, want.targets):
            np.testing.assert_array_equal(a, b, err_msg=name)


class _SizesOnly:
    """A factory stand-in with mixed orientations: the loaders read only
    ``len`` and ``dataset.image_size`` to plan batches."""

    def __init__(self, n):
        rng = np.random.default_rng(5)
        self.sizes = [(int(w), int(h)) for w, h in rng.integers(50, 200, (n, 2))]
        self.dataset = self

    def __len__(self):
        return len(self.sizes)

    def image_size(self, i):
        return self.sizes[i]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("shards", [1, 3])
def test_loader_batch_order_and_sharding_equal(shuffle, shards):
    stub = _SizesOnly(23)
    seen = []
    for shard in range(shards):
        kw = dict(batch_size=4, shuffle=shuffle, num_shards=shards, shard_index=shard, seed=7)
        j, p = jfactory.HOILoader(stub, **kw), factory.HOILoader(stub, **kw)
        for epoch in (0, 1):
            j.set_epoch(epoch)
            p.set_epoch(epoch)
            assert p._batches() == j._batches()
            assert len(p) == len(j)
        seen += [i for b in p._batches() for i in b]
        for b in p._batches():  # one orientation per batch
            assert len({stub.sizes[i][1] > stub.sizes[i][0] for i in b}) == 1
    assert sorted(seen) == list(range(23))


def _batches_equal(got, want):
    assert len(got) == len(want) > 0
    for (gb, gi), (wb, wi) in zip(got, want):
        assert gi == wi
        for a, b in zip(gb[:-1], wb[:-1]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if wb.targets is not None:
            for a, b in zip(gb.targets, wb.targets):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_loader_batches_equal_jax_and_short_batches_repeat_the_last(roots):
    jf, pf = _factories(roots, flip=True, seed=1)
    want = list(jfactory.HOILoader(jf, 4, shuffle=True, seed=2))
    got = list(factory.HOILoader(pf, 4, shuffle=True, seed=2))
    _batches_equal(got, want)
    short = [(b, i) for b, i in got if len(i) < 4]
    assert short, "6 images in batches of 4 leave a short batch"
    for batch, idx in short:
        for slot in range(len(idx), 4):
            np.testing.assert_array_equal(batch.images[slot], batch.images[len(idx) - 1])


def test_threaded_loader_matches_synchronous(roots):
    _, pf = _factories(roots, flip=True, seed=1)
    sync = list(factory.HOILoader(pf, 2, shuffle=True, seed=3))
    threaded = list(factory.HOILoader(pf, 2, shuffle=True, seed=3, num_workers=3, prefetch=2))
    _batches_equal(threaded, sync)


def test_to_device_on_the_cpu(roots):
    _, pf = _factories(roots, flip=True, seed=1)
    batch, _ = next(iter(factory.HOILoader(pf, 2, with_targets=True)))
    moved = factory.to_device(batch, "cpu")
    assert moved.det_labels.dtype == moved.targets.object.dtype == moved.targets.labels.dtype \
        == torch.int64
    assert moved.det_valid.dtype == torch.bool and moved.images.dtype == torch.float32
    for a, b in zip(moved[:-1], batch[:-1]):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(moved.targets, batch.targets):
        np.testing.assert_array_equal(a.numpy(), b)


def _raw_batch(sizes, raw_canvas, canvas, min_size, max_size, seed=0):
    rng = np.random.default_rng(seed)
    raws = np.zeros((len(sizes), *raw_canvas, 3), np.uint8)
    orig = np.zeros((len(sizes), 2), np.float32)
    new = np.zeros((len(sizes), 2), np.float32)
    images = []
    for i, (h, w) in enumerate(sizes):
        images.append(rng.integers(0, 256, (h, w, 3), np.uint8))
        raws[i, :h, :w] = images[-1]
        nh, nw = resized_size(h, w, resize_scale(h, w, min_size, max_size))
        orig[i], new[i] = (h, w), (min(nh, canvas[0]), min(nw, canvas[1]))
    return images, raws, orig, new


@pytest.mark.parametrize("dtype", ["uint8", "float"])
def test_device_resize_matches_jax_and_host(dtype):
    canvas = (64, 96)
    sizes = [(50, 75), (40, 120), (64, 96), (33, 47)]  # incl. an exact fit
    images, raws, orig, new = _raw_batch(sizes, (96, 128), canvas, 48, 96)
    raw_in = raws if dtype == "uint8" else raws.astype(np.float32) / 255.0
    want = np.asarray(jax_device_resize(jnp.asarray(raw_in), jnp.asarray(orig), jnp.asarray(new),
                                        canvas))
    got = device_resize_canvas(torch.from_numpy(raw_in), torch.from_numpy(orig),
                               torch.from_numpy(new), canvas)
    assert got.dtype == torch.float32 and got.shape == (4, *canvas, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for i, img in enumerate(images):
        host, hw, _ = prepare_image(img, canvas, 48, 96)
        jhost, _, _ = jax_prepare_image(Image.fromarray(img), canvas, 48, 96)
        np.testing.assert_array_equal(host, jhost)
        assert hw == tuple(int(x) for x in new[i])
        np.testing.assert_allclose(got[i].numpy(), host, rtol=0, atol=2e-5, err_msg=str(i))
        nh = hw[0]
        if nh < canvas[0]:
            np.testing.assert_array_equal(got[i, nh:].numpy(), np.broadcast_to(
                np.float32(C.IMAGE_MEAN), got[i, nh:].shape))


def test_prepare_batch_picks_the_canvas_by_orientation(roots):
    kw = dict(device_resize=True, raw_canvas_landscape=(128, 160),
              raw_canvas_portrait=(160, 128))
    for partition, canvas in (("train2015", (64, 96)), ("test2015", (96, 64))):
        _, pf = _factories(roots, partition, **kw)
        _, hf = _factories(roots, partition)
        raw, _ = next(iter(factory.HOILoader(pf, 2)))
        host, _ = next(iter(factory.HOILoader(hf, 2)))
        out = prepare_batch(factory.to_device(raw, "cpu"), pf)
        assert out.images.shape == (2, *canvas, 3)
        np.testing.assert_allclose(out.images.numpy(), host.images, rtol=0, atol=2e-5)
        assert prepare_batch(out, pf) is out  # float batches pass through


def test_resize_and_hflip_boxes_match_jax():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 300, (5, 7, 4)).astype(np.float32)
    for orig, new in (((480, 640), (800, 1066)), ((333, 500), (800, 1201)), ((75, 50), (96, 64))):
        want = np.asarray(jboxes.resize_boxes(jnp.asarray(boxes), orig, new))
        got = resize_boxes(torch.from_numpy(boxes), orig, new)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # per-image sizes as tensors, broadcast over the boxes
    orig = rng.uniform(100, 500, (5, 1, 2)).astype(np.float32)
    new = rng.uniform(100, 900, (5, 1, 2)).astype(np.float32)
    got = resize_boxes(torch.from_numpy(boxes), torch.from_numpy(orig).unbind(-1),
                       torch.from_numpy(new).unbind(-1))
    for i in range(5):
        want = np.asarray(jboxes.resize_boxes(jnp.asarray(boxes[i]), tuple(orig[i, 0]),
                                              tuple(new[i, 0])))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-6, atol=1e-6)
    for width in (640.0, 97.5):
        want = np.asarray(jboxes.hflip_boxes(jnp.asarray(boxes), width))
        np.testing.assert_allclose(hflip_boxes(torch.from_numpy(boxes), width).numpy(), want,
                                   rtol=1e-6, atol=1e-6)
