"""The port's user tools on the CPU, held to the JAX package's tools.

Host tools (``hico_meta``, ``text_label``, ``hicodet_split``, ``navigator``,
``generate_html_page``, ``kge_results_table``, ``kge_relation_stats``,
``visualise_and_cache``): the same inputs give the same tables, files and
stdout.  Device tools on the CPU: ``visualise_detections --cpu`` (the kept
boxes and the JPEG's pixels equal to JAX's), ``demo --cpu --synthetic`` with
JAX weights converted by ``weights.to_state_dict`` (pairs, verbs and
objects equal, scores within 1e-4), and ``extract_roi_features`` with the
converted JAX backbone (``.npz`` keys, boxes, labels, scores and ``n_h``
equal; features within 1e-4 of the largest).  ``utils``: ``get_logger``
off rank 0, ``trace`` on the CPU.

The JAX demo and extraction tools run their networks eagerly, which on the
CPU compiles every primitive on its own (~50 s for the SCG's ``init``,
~30 s for its ``apply``); the tests route ``init`` (whose values are the
eager call's, bit for bit) and the demo's ``apply`` through ``jax.jit`` of
the same calls, so each JAX tool's ``main`` runs once, at 64x96.
"""

import io
import json
import logging
import os
import shutil
import sys
import tempfile

import jax
import numpy as np
import pytest
import scipy.io as sio
import torch
from PIL import Image

from skghoi_tpu.data import hico_meta as jax_hico_meta
from skghoi_tpu.data import text_label as jax_text_label
from skghoi_tpu.data.factory import DataFactory as JaxDataFactory
from skghoi_tpu.data.factory import collate as jax_collate
from skghoi_tpu.models import SpatiallyConditionedGraph as JaxSCG
from skghoi_tpu.models.backbone import DetectorBackbone as JaxBackbone
from skghoi_tpu.tools import demo as jax_demo
from skghoi_tpu.tools import extract_roi_features as jax_extract
from skghoi_tpu.tools import generate_html_page as jax_generate_html_page
from skghoi_tpu.tools import hicodet_split as jax_hicodet_split
from skghoi_tpu.tools import kge_relation_stats as jax_kge_relation_stats
from skghoi_tpu.tools import kge_results_table as jax_kge_results_table
from skghoi_tpu.tools import navigator as jax_navigator
from skghoi_tpu.tools import visualise_and_cache as jax_visualise_and_cache
from skghoi_tpu.tools import visualise_detections as jax_visualise_detections
from skghoi_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from skghoi_torch.data import hico_meta, text_label
from skghoi_torch.data.factory import DataFactory, HOILoader
from skghoi_torch.data.synthetic import make_synthetic_hicodet
from skghoi_torch.models.backbone import DetectorBackbone
from skghoi_torch.tools import (cache_results, demo, extract_roi_features, generate_html_page,
                                hicodet_split, kge_relation_stats, kge_results_table, navigator,
                                train_kge, visualise_and_cache, visualise_detections)
from skghoi_torch.train.checkpoint import save_checkpoint
from skghoi_torch.utils import get_logger, trace
from skghoi_torch.utils import logging as port_logging
from skghoi_torch.weights import to_state_dict

torch.set_num_threads(2)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed when the test ends, passed or failed:
    pytest keeps the directories of its last three runs, and the demo's
    checkpoints are hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


SMALL = dict(min_size=64, max_size=107, canvas_landscape=(64, 96), canvas_portrait=(96, 64))


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs, a.choices)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("port, jax_tool", [
    (demo, jax_demo), (extract_roi_features, jax_extract),
    (visualise_detections, jax_visualise_detections)],
    ids=["demo", "extract_roi_features", "visualise_detections"])
def test_same_flags_and_defaults(port, jax_tool):
    assert _flags(port.build_argparser()) == _flags(jax_tool.build_argparser())


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Synthetic HICO-DET, both partitions (the port's writer, whose files
    equal the JAX writer's byte for byte: ``test_torch_port_data.py``)."""
    root = str(tmp_path_factory.mktemp("synth"))
    try:
        make_synthetic_hicodet(root, "train2015", num_images=6)
        make_synthetic_hicodet(root, "test2015", num_images=6)
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


# --- host tools ---------------------------------------------------------

@pytest.mark.parametrize("name", ["HICO_OBJECTS", "HICO_OBJECTS_COCO_ORDER", "HICO_VERBS",
                                  "HICO_INTERACTIONS", "HICO_UNSEEN_INDEX"])
def test_hico_meta_tables_equal(name):
    assert getattr(hico_meta, name) == getattr(jax_hico_meta, name)


def test_text_label_matches_jax(tmp_path):
    verbs, objects = hico_meta.HICO_VERBS, hico_meta.HICO_OBJECTS
    corr = [(i, o, v) for i, (v, o) in enumerate(hico_meta.HICO_INTERACTIONS)]
    assert [text_label.gerund(v) for v in verbs] == [jax_text_label.gerund(v) for v in verbs]
    assert [text_label.article(o) for o in objects] == [jax_text_label.article(o) for o in objects]
    assert [text_label.pair_prompt(verbs[v], objects[o]) for _, o, v in corr] == [
        jax_text_label.pair_prompt(verbs[v], objects[o]) for _, o, v in corr]
    assert (text_label.hico_text_labels(corr, verbs, objects)
            == jax_text_label.hico_text_labels(corr, verbs, objects))
    assert len(text_label.hico_text_labels(corr, verbs, objects)) == 600
    assert text_label.hico_obj_text_labels(objects) == jax_text_label.hico_obj_text_labels(objects)
    assert (text_label.verb_to_objects(corr, len(verbs))
            == jax_text_label.verb_to_objects(corr, len(verbs)))
    counts = np.random.default_rng(0).integers(0, 50, 600).tolist()
    custom = tmp_path / "splits.json"
    custom.write_text(json.dumps({"uc0": [1, 5, 9]}))
    for kw in ({}, dict(num_unseen=10), dict(custom_splits_json=str(custom))):
        assert (text_label.unseen_index_splits(counts, **kw)
                == jax_text_label.unseen_index_splits(counts, **kw))


def test_hicodet_split_same_json(synth, tmp_path, capsys):
    outs = []
    for tool, name in ((hicodet_split, "port.json"), (jax_hicodet_split, "jax.json")):
        path = str(tmp_path / name)
        text = _run(tool.main, ["--data-root", synth, "--ratio", "0.5", "--seed", "3",
                                "--output", path], capsys)
        outs.append((open(path, "rb").read(), text.replace(path, "OUT")))
    assert outs[0] == outs[1]
    assert json.loads(outs[0][0])["train"]


def test_navigator_same_session(synth, capsys, monkeypatch):
    script = "help\nclasses\nclasses ride\ncounts\nobjects\nverbs\nimage 1\nbogus\n\nquit\n"
    texts = []
    for tool in (navigator, jax_navigator):
        monkeypatch.setattr(sys, "stdin", io.StringIO(script))
        texts.append(_run(tool.main, ["--data-root", synth, "--partition", "test2015"], capsys))
    assert texts[0] == texts[1]
    assert "6 images" in texts[0] and "h=" in texts[0] and "unknown command" in texts[0]


@pytest.mark.parametrize("per_page", [100, 2], ids=["one_page", "three_pages"])
def test_generate_html_page_same_bytes(synth, tmp_path, capsys, monkeypatch, per_page):
    images = os.path.join(synth, "hico_20160224_det/images/test2015")
    pages = []
    for tool, sub in ((generate_html_page, "port"), (jax_generate_html_page, "jax")):
        os.makedirs(tmp_path / sub)
        monkeypatch.chdir(tmp_path / sub)  # the pages link each other by --output's path
        text = _run(tool.main, [images, "--output", "gallery.html", "--per-page", str(per_page)],
                    capsys)
        files = sorted(os.listdir(tmp_path / sub))
        pages.append((text, files, [open(tmp_path / sub / f, "rb").read() for f in files]))
    assert pages[0] == pages[1]
    assert len(pages[0][1]) == (1 if per_page == 100 else 3)


def _kg_dir(root, n_ent=30, n_rel=4, seed=0):
    """A small random KG in OpenKE's files (count line, then ``h t r``)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    files = {"entity2id.txt": f"{n_ent}\n", "relation2id.txt": f"{n_rel}\n"}
    for name, n in (("train2id.txt", 120), ("valid2id.txt", 20), ("test2id.txt", 40)):
        hs = rng.integers(0, n_ent // (1 + (np.arange(n) % 3)), n)  # skewed heads
        trip = np.stack([hs, rng.integers(0, n_ent, n), rng.integers(0, n_rel, n)], 1)
        files[name] = f"{n}\n" + "".join(f"{h} {t} {r}\n" for h, t, r in trip)
    for name, text in files.items():
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
    return str(root)


def test_kge_relation_stats_same_files(tmp_path, capsys):
    data = _kg_dir(tmp_path / "kg")
    outs = []
    for tool, sub in ((kge_relation_stats, "port"), (jax_kge_relation_stats, "jax")):
        text = _run(tool.main, ["--data", data, "--output-dir", str(tmp_path / sub)], capsys)
        files = {f: open(tmp_path / sub / f).read() for f in sorted(os.listdir(tmp_path / sub))}
        outs.append((text, files))
    assert outs[0] == outs[1]
    assert sorted(outs[0][1]) == ["1-1.txt", "1-n.txt", "n-1.txt", "n-n.txt"]
    assert sum(int(t.splitlines()[0]) for t in outs[0][1].values()) >= 40


def test_kge_results_table_same_table(tmp_path, capsys):
    """JAX's own test rows (``tests/test_eval_tools.py``), then a row that
    the port's ``train_kge --json-out`` wrote for a KG in a ``WN18RR`` dir."""
    rows = [
        dict(model="transe", data="/x/WN18RR", example="transe_wn18rr",
             hit10=0.533, mrr=0.232, steps_per_second=46.4),
        dict(model="transe", data="/x/WN18RR", example="transe_wn18rr",
             hit10=0.031, mrr=0.01, steps_per_second=48.0),
    ]
    rows.append(dict(rows[0]))
    jax_rows = tmp_path / "r.jsonl"
    jax_rows.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    port_rows = str(tmp_path / "port.jsonl")
    train_kge.main(["--data", _kg_dir(tmp_path / "WN18RR"), "--epochs", "1", "--device", "cpu",
                    "--dim", "8", "--nbatches", "2", "--neg-ent", "2", "--json-out", port_rows])
    capsys.readouterr()
    for paths in ([str(jax_rows)], [port_rows], [str(jax_rows), port_rows]):
        tables = [_run(tool.main, paths, capsys)
                  for tool in (kge_results_table, jax_kge_results_table)]
        assert tables[0] == tables[1]
    assert "transe_wn18rr" in tables[0] and "+0.021" in tables[0] and "0.031" not in tables[0]
    assert "| transe | WN18RR |" in tables[0] and "| 0.512 |" in tables[0]


def test_visualise_and_cache_same_output(synth, tmp_path, capsys):
    """On ``.mat`` files that the port's ``cache_results`` wrote."""
    mats = str(tmp_path / "mat")
    cache_results.main(["--dataset", "hicodet", "--synthetic", "--cpu", "--synthetic-root",
                        str(tmp_path / "cache_synth"), "--partition", "test2015",
                        "--cache-dir", mats, "--batch-size", "2"])
    capsys.readouterr()
    found = [(o, r) for o in range(80)
             for r in range(sio.loadmat(os.path.join(mats, f"detections_{o:02d}.mat"))
                            ["all_boxes"].shape[0])
             if len(visualise_and_cache.ranked_scores(mats, o, r)[1])]
    assert found, "cache_results wrote no detection"
    obj, row = found[0]
    out = str(tmp_path / "pr.png")
    for argv in (["--object", str(obj), "--row", str(row), "--num-gt", "5"],
                 ["--object", str(obj), "--row", str(row)]):
        texts = [_run(tool.main, ["--cache-dir", mats, "--output", out] + argv, capsys)
                 for tool in (visualise_and_cache, jax_visualise_and_cache)]
        assert texts[0] == texts[1] and "Saved" in texts[0]
    path, scores = visualise_and_cache.ranked_scores(mats, obj, row)
    assert np.all(np.diff(scores) <= 0) and os.path.exists(out)


# --- device tools on the CPU ---------------------------------------------

def test_visualise_detections_matches_jax(synth, tmp_path, capsys, monkeypatch):
    import skghoi_tpu.ops.boxes as jax_boxes

    masks = []
    jax_nms = jax_boxes.nms_keep

    def recording_nms(*args):
        masks.append(np.asarray(jax_nms(*args)))
        return masks[-1]

    monkeypatch.setattr(jax_boxes, "nms_keep", recording_nms)
    det_root = os.path.join(synth, "detections_test2015")
    argv = ["--data-root", synth, "--detection-root", det_root, "--partition", "test2015",
            "--image-idx", "0", "--box-score-thresh", "0.1", "--nms-thresh", "0.3", "--cpu"]
    port_jpg, jax_jpg = str(tmp_path / "port.jpg"), str(tmp_path / "jax.jpg")
    kept = visualise_detections.main(argv + ["--out-file", port_jpg])
    jax_visualise_detections.main(argv + ["--out-file", jax_jpg])
    capsys.readouterr()

    name = sorted(os.listdir(det_root))[0]
    det = json.load(open(os.path.join(det_root, name)))
    scores = np.asarray(det["scores"], np.float32)
    boxes = np.asarray(det["boxes"], np.float32).reshape(-1, 4)[scores >= 0.1]
    assert len(masks) == 1 and 0 < masks[0].sum() < len(boxes)  # NMS dropped some
    np.testing.assert_array_equal(kept[0], boxes[masks[0]])
    np.testing.assert_array_equal(kept[1], scores[scores >= 0.1][masks[0]])
    np.testing.assert_array_equal(np.asarray(Image.open(port_jpg)),
                                  np.asarray(Image.open(jax_jpg)))


@pytest.fixture(scope="module")
def jax_scg(synth):
    """One jitted JAX SCG ``init`` on a one-image 64x96 batch, which stands
    in for the demo's own ``init`` (key 0), and the weights of the
    checkpoints the demo loads (key 1)."""
    factory = JaxDataFactory("hicodet", "test2015", synth,
                             os.path.join(synth, "detections_test2015"), **SMALL)
    batch = jax_collate([factory[0]], with_targets=False)
    ovm = factory.dataset.object_verb_mask()
    init = jax.jit(lambda rng, b, m: JaxSCG().init(rng, b, m, training=False))
    weights = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(1), batch, ovm))
    return init, weights


def test_demo_matches_jax(synth, jax_scg, tmp_path, capsys, monkeypatch):
    import skghoi_tpu.eval.hoi_eval as jax_hoi_eval

    init, weights = jax_scg
    jax_ckpt, port_ckpt = str(tmp_path / "jax_ckpt"), str(tmp_path / "port.pt")
    jax_save_checkpoint(jax_ckpt, weights, {"step": np.zeros(())}, 0, 0)
    save_checkpoint(port_ckpt, to_state_dict(weights), {}, 0, 0)

    results = []
    jax_unpack = jax_hoi_eval.unpack_image_results
    monkeypatch.setattr(jax_hoi_eval, "unpack_image_results",
                        lambda *a, **k: results.append(jax_unpack(*a, **k)) or results[-1])
    jax_apply = JaxSCG.apply
    apply = jax.jit(lambda v, b, m: jax_apply(JaxSCG(), v, b, m, training=False))
    monkeypatch.setattr(JaxSCG, "init", lambda self, rng, b, m, training=False: init(rng, b, m))
    monkeypatch.setattr(JaxSCG, "apply", lambda self, v, b, m, training=False: apply(v, b, m))
    # --synthetic writes its dataset into tempfile.mkdtemp(): the same seeded
    # files in one directory for both tools.
    demo_root = str(tmp_path / "demo_root")
    monkeypatch.setattr(tempfile, "mkdtemp", lambda **kw: demo_root)
    out = str(tmp_path / "overlay.png")
    argv = ["--synthetic", "--cpu", "--index", "1", "--top-k", "3", "--output", out]
    port = demo.main(argv + ["--model-path", port_ckpt])
    port_text = capsys.readouterr().out
    jax_demo.main(argv + ["--model-path", jax_ckpt])
    jax_text = capsys.readouterr().out

    (want,) = results
    got = port["res"]
    assert len(port["pairs"]) > 1 and "box pairs" in port_text and os.path.exists(out)
    for key in ("pair_index", "prediction", "object"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes_h"], want["boxes_h"], rtol=0, atol=1e-3)
    assert port_text == jax_text


def test_extract_roi_features_matches_jax(tmp_path, capsys, monkeypatch):
    """The JAX tool's seeded backbone, converted, through the port's
    extraction on the same synthetic data."""
    init = jax.jit(lambda rng, x: JaxBackbone().init(rng, x))
    variables = init(jax.random.PRNGKey(0), np.zeros((4, 64, 96, 3), np.float32))
    monkeypatch.setattr(JaxBackbone, "init", lambda self, rng, x: init(rng, x))
    root = str(tmp_path / "roi_root")
    monkeypatch.setattr(tempfile, "mkdtemp", lambda **kw: root)  # --synthetic's dataset
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_extract.main(["--synthetic", "--cpu", "--partition", "train2015", "--output-dir", jax_dir])

    sd = to_state_dict(jax.tree_util.tree_map(np.asarray, {
        col: {"detector": tree} for col, tree in variables.items()}))
    backbone = DetectorBackbone(device="cpu").eval()
    backbone.load_state_dict({k[len("detector."):]: v for k, v in sd.items()}, strict=True)
    factory = DataFactory("hicodet", "train2015", root,
                          os.path.join(root, "detections_train2015"), **SMALL)
    loader = HOILoader(factory, 4, shuffle=False, with_targets=False)
    count = extract_roi_features.extract_features(backbone, loader, port_dir)
    capsys.readouterr()

    names = sorted(os.listdir(jax_dir))
    assert count == len(factory) == 4 and names == sorted(os.listdir(port_dir)) and len(names) == 4
    for name in names:
        got, want = np.load(os.path.join(port_dir, name)), np.load(os.path.join(jax_dir, name))
        assert sorted(got.files) == sorted(want.files)
        for key in ("boxes", "labels", "scores", "n_h"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
        f_got, f_want = got["features"], want["features"]
        assert f_got.shape == f_want.shape and f_got.shape[1:] == (7, 7, 256)
        assert f_got.shape[0] > 0
        np.testing.assert_allclose(f_got, f_want, rtol=0, atol=1e-4 * np.abs(f_want).max())


# --- utils ----------------------------------------------------------------

def test_logger_silenced_off_rank_0(monkeypatch):
    monkeypatch.setattr(port_logging, "is_main", lambda: False)
    assert get_logger("skghoi_torch.test.rank1").level == logging.ERROR
    monkeypatch.setattr(port_logging, "is_main", lambda: True)
    log = get_logger("skghoi_torch.test.rank0")
    assert log.level == logging.INFO and get_logger("skghoi_torch.test.rank0") is log


def test_trace_writes_a_trace_on_cpu(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.ones(4, 4).matmul(torch.ones(4, 4))
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "traceEvents" in json.load(open(tmp_path / "prof" / files[0]))
    with trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not os.path.exists(tmp_path / "off")
