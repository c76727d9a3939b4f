"""The port's command-line tools on the CPU, held to what the JAX tools do.

The chain ``train_hicodet --synthetic --cpu`` -> ``test_hicodet`` ->
``cache_results --dataset hicodet`` over one synthetic dataset, asserting
what ``tests/test_cli_pipeline.py::test_hicodet_cli_chain`` asserts of the
JAX tools (the ``Epoch`` and ``Training complete.`` lines, a checkpoint,
``Loaded checkpoint``, the mAP line, 80 ``.mat`` files with ``all_boxes``);
a ``--device-resize`` training run; the same flags and defaults as the JAX
tools.  The KGE tools: ``train_kge --device cpu`` on a ring KG (the JAX
tool's log lines and JSON line; ``--data-parallel`` refused, naming the DDP
slice), its checkpoint round trip (``--load-checkpoint --epochs 0``
reprints the same metrics), ``pretrain_transh_hoi --synthetic --device cpu``
then ``train_hicodet --synthetic --transh-init`` (the SCG's TransH tables
equal the checkpoint's; one epoch trains), a TransH checkpoint that does not
fit the graph head refused with a reason, and a JAX msgpack checkpoint of
the JAX ``pretrain_transh_hoi`` converted by ``weights.kge_state_dict``
giving the same SCG TransH tables as JAX's ``load_pretrained_transh``.
"""

import glob
import json
import os

import numpy as np
import pytest
import scipy.io as sio
import torch
from flax import serialization

from skghoi_tpu.tools import cache_results as jax_cache_results
from skghoi_tpu.tools import pretrain_transh_hoi as jax_pretrain_transh_hoi
from skghoi_tpu.tools import test_hicodet as jax_test_hicodet
from skghoi_tpu.tools import train_hicodet as jax_train_hicodet
from skghoi_tpu.tools import train_kge as jax_train_kge
from skghoi_torch import constants as C
from skghoi_torch.entry import build_model
from skghoi_torch.kge import TransH
from skghoi_torch.tools import (cache_results, pretrain_transh_hoi, test_hicodet, train_hicodet,
                                train_kge)
from skghoi_torch.weights import kge_state_dict

torch.set_num_threads(2)


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs, a.choices)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("port, jax_tool", [
    (train_hicodet, jax_train_hicodet), (test_hicodet, jax_test_hicodet),
    (cache_results, jax_cache_results)], ids=["train_hicodet", "test_hicodet", "cache_results"])
def test_same_flags_and_defaults(port, jax_tool):
    assert _flags(port.build_argparser()) == _flags(jax_tool.build_argparser())


def test_hicodet_cli_chain(tmp_path, capsys):
    root = str(tmp_path / "synth")
    ckpt_dir = str(tmp_path / "ckpts")
    mat_dir = str(tmp_path / "mat")

    engine = train_hicodet.main([
        "--synthetic", "--cpu", "--synthetic-root", root, "--cache-dir", ckpt_dir,
        "--batch-size", "2", "--num-workers", "2",
    ])
    ckpts = sorted(glob.glob(os.path.join(ckpt_dir, "ckpt_*")))
    assert [os.path.basename(c) for c in ckpts] == ["ckpt_01.pt"]
    out = capsys.readouterr().out
    assert "Epoch: 0 | training mAP: " in out and "Training complete." in out
    assert out.count("=> HOI classification loss: ") == 4  # 8 images, batch 2, interval 1
    assert engine.epoch == 1 and engine.iteration == 4
    assert all(p.device.type == "cpu" for p in engine.model.parameters())

    result = test_hicodet.main([
        "--synthetic", "--cpu", "--synthetic-root", root, "--model-path", ckpts[-1],
        "--batch-size", "2",
    ])
    out = capsys.readouterr().out
    assert "Loaded checkpoint" in out
    assert "The mAP is " in out and "none-rare: " in out
    assert all(0.0 <= result[k] <= 1.0 for k in ("full", "rare", "non_rare"))

    cache_results.main([
        "--dataset", "hicodet", "--synthetic", "--cpu", "--synthetic-root", root,
        "--model-path", ckpts[-1], "--cache-dir", mat_dir, "--batch-size", "2",
    ])
    assert "Loading model from" in capsys.readouterr().out
    mats = sorted(glob.glob(os.path.join(mat_dir, "detections_*.mat")))
    assert len(mats) == 80, f"expected 80 per-object .mat files, got {len(mats)}"
    assert "all_boxes" in sio.loadmat(mats[0])


def test_train_hicodet_device_resize(tmp_path, capsys):
    """Raw uint8 batches resized on the device through the real CLI."""
    ckpt_dir = str(tmp_path / "ckpts_devres")
    engine = train_hicodet.main([
        "--synthetic", "--cpu", "--synthetic-root", str(tmp_path / "synth_devres"),
        "--cache-dir", ckpt_dir, "--batch-size", "4", "--num-workers", "0", "--device-resize",
    ])
    out = capsys.readouterr().out
    assert "Epoch" in out and "Training complete." in out
    assert glob.glob(os.path.join(ckpt_dir, "ckpt_*"))
    assert engine.train_loader.factory.device_resize and engine.iteration == 2


def test_transh_init_is_refused(tmp_path):
    """A TransH checkpoint whose tables do not fit the graph head is refused
    with a reason before training; a missing one before anything is written."""
    bad = str(tmp_path / "transh_dim8.pt")
    torch.save(TransH(C.HICO_NUM_OBJECTS, C.HICO_NUM_VERBS, dim=8).state_dict(), bad)
    with pytest.raises(ValueError, match="TransH table ent_embeddings"):
        train_hicodet.main(["--synthetic", "--cpu", "--synthetic-root", str(tmp_path / "s1"),
                            "--cache-dir", str(tmp_path / "ck"), "--transh-init", bad])
    assert not (tmp_path / "ck").exists()
    with pytest.raises(FileNotFoundError):
        train_hicodet.main(["--synthetic", "--cpu", "--synthetic-root", str(tmp_path / "s2"),
                            "--transh-init", str(tmp_path / "missing.pt")])
    assert not (tmp_path / "s2").exists()


def test_train_kge_flags_match_jax():
    """The JAX tool's flags, except ``--device`` in place of ``--cpu``."""
    port, jax_flags = _flags(train_kge.build_argparser()), _flags(jax_train_kge.build_argparser())
    assert port.pop("device")[:2] == (("--device",), None)
    assert jax_flags.pop("cpu")[0] == ("--cpu",)
    assert port == jax_flags


def ring_dir(root, n_ent=20):
    """A ring KG (i -> i+1 under relation 0) as OpenKE files, all edges in
    train and test, with a type constraint admitting the even entities."""
    os.makedirs(root, exist_ok=True)
    ring = [(i, (i + 1) % n_ent, 0) for i in range(n_ent)]
    files = {"entity2id.txt": f"{n_ent}\n", "relation2id.txt": "1\n",
             "type_constrain.txt": "1\n" + ("0 10 " + " ".join(map(str, range(0, n_ent, 2))) + "\n") * 2}
    for name in ("train2id.txt", "test2id.txt"):
        files[name] = f"{n_ent}\n" + "".join(f"{h} {t} {r}\n" for h, t, r in ring)
    for name, text in files.items():
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
    return str(root)


KGE_ARGS = ["--device", "cpu", "--dim", "8", "--nbatches", "2", "--neg-ent", "4", "--alpha", "0.5"]


def test_train_kge_cli(tmp_path, capsys):
    root = ring_dir(tmp_path / "ring")
    json_out = str(tmp_path / "kge.jsonl")
    res = train_kge.main(["--data", root, "--epochs", "2", "--type-constrain", "--json",
                          "--json-out", json_out] + KGE_ARGS)
    out = capsys.readouterr().out
    for line in ("Loaded " + root + ": 20 entities, 1 relations, 20 train / 0 valid / 20 test",
                 "Epoch 0 | loss: ", "Epoch 1 | loss: ", "Training: ", "averaged(filter):",
                 "type-constrained(filter): MRR", "Evaluation: "):
        assert line in out, line
    with open(json_out) as f:
        row = json.loads(f.read().strip().splitlines()[-1])
    assert row["platform"] == "cpu" and row["model"] == "transe"
    assert (row["mrr"], row["hit10"]) == (res.mrr, res.hit10) and 0 < res.mrr <= 1

    with pytest.raises(SystemExit):
        train_kge.main(["--data", root, "--data-parallel"] + KGE_ARGS)
    assert "DDP" in capsys.readouterr().err


def test_train_kge_checkpoint_roundtrip(tmp_path, capsys):
    root = ring_dir(tmp_path / "ring")
    ckpt = str(tmp_path / "ck" / "transh.pt")
    args = ["--data", root, "--model", "transh", "--type-constrain"] + KGE_ARGS
    first = train_kge.main(args + ["--epochs", "3", "--checkpoint", ckpt])
    again = train_kge.main(args + ["--epochs", "0", "--load-checkpoint", ckpt])
    out = capsys.readouterr().out
    assert f"Loaded checkpoint {ckpt}" in out and "Training skipped (--epochs 0)" in out
    assert tuple(again) == tuple(first) and again.raw == first.raw
    assert set(torch.load(ckpt)) == {"ent_embeddings.weight", "rel_embeddings.weight",
                                     "norm_vector.weight"}


def transh_tables(model):
    transh = model.interaction_head.box_pair_head.transh
    return {f"{t}.weight": getattr(transh, t).weight.detach() for t in pretrain_transh_hoi.TRANSH_TABLES}


def test_pretrain_transh_then_train_hicodet_transh_init(tmp_path, capsys):
    pt = str(tmp_path / "transh_hoi.pt")
    kge = pretrain_transh_hoi.main(["--synthetic", "--device", "cpu", "--epochs", "3",
                                    "--output", pt])
    saved = torch.load(pt)
    assert {k: tuple(v.shape) for k, v in saved.items()} == {
        "ent_embeddings.weight": (80, 50), "rel_embeddings.weight": (117, 50),
        "norm_vector.weight": (117, 50)}
    assert all(torch.equal(v, kge.state_dict()[k]) for k, v in saved.items())

    root = str(tmp_path / "synth")
    common = ["--synthetic", "--cpu", "--synthetic-root", root, "--batch-size", "4",
              "--num-workers", "0", "--transh-init", pt]
    loaded = train_hicodet.main(common + ["--num-epochs", "0", "--cache-dir", str(tmp_path / "c0")])
    got = transh_tables(loaded.model)
    assert all(torch.equal(got[k], v) for k, v in saved.items())

    engine = train_hicodet.main(common + ["--cache-dir", str(tmp_path / "c1")])
    out = capsys.readouterr().out
    assert out.count(f"Initialized TransH embeddings from {pt}") == 2
    assert "Epoch: 0 | training mAP: " in out and "Training complete." in out
    assert engine.iteration == 2 and os.path.exists(tmp_path / "c1" / "ckpt_01.pt")
    assert not torch.equal(transh_tables(engine.model)["rel_embeddings.weight"],
                           saved["rel_embeddings.weight"])  # the tables trained on


def test_jax_transh_checkpoint_converts_like_load_pretrained_transh(tmp_path):
    msgpack = str(tmp_path / "transh_hoi.ckpt")
    jax_pretrain_transh_hoi.main(["--synthetic", "--epochs", "2", "--output", msgpack])
    with open(msgpack, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    shapes = {"ent_embeddings": (80, 50), "rel_embeddings": (117, 50), "norm_vector": (117, 50)}
    scg = {"params": {"interaction_head": {"box_pair_head": {"transh": {
        t: {"embedding": np.zeros(s, np.float32)} for t, s in shapes.items()}}}}}
    want = jax_pretrain_transh_hoi.load_pretrained_transh(scg, tree)
    want = want["params"]["interaction_head"]["box_pair_head"]["transh"]

    model = build_model(device="cpu", num_iterations=1)
    pretrain_transh_hoi.load_pretrained_transh(model, kge_state_dict(tree))
    got = transh_tables(model)
    for t in shapes:
        assert np.array_equal(got[f"{t}.weight"].numpy(), np.asarray(want[t]["embedding"])), t
