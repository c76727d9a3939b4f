"""The port's command-line tools on the CPU, held to what the JAX tools do.

The chain ``train_hicodet --synthetic --cpu`` -> ``test_hicodet`` ->
``cache_results --dataset hicodet`` over one synthetic dataset, asserting
what ``tests/test_cli_pipeline.py::test_hicodet_cli_chain`` asserts of the
JAX tools (the ``Epoch`` and ``Training complete.`` lines, a checkpoint,
``Loaded checkpoint``, the mAP line, 80 ``.mat`` files with ``all_boxes``);
a ``--device-resize`` training run; the same flags and defaults as the JAX
tools; ``--transh-init`` refused with a reason.
"""

import glob
import os

import pytest
import scipy.io as sio
import torch

from skghoi_tpu.tools import cache_results as jax_cache_results
from skghoi_tpu.tools import test_hicodet as jax_test_hicodet
from skghoi_tpu.tools import train_hicodet as jax_train_hicodet
from skghoi_torch.tools import cache_results, test_hicodet, train_hicodet

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


def test_transh_init_is_refused(tmp_path, capsys):
    with pytest.raises(SystemExit):
        train_hicodet.main(["--synthetic", "--cpu", "--synthetic-root", str(tmp_path),
                            "--transh-init", "transh.msgpack"])
    assert "KGE" in capsys.readouterr().err
    assert not os.listdir(tmp_path)  # refused before anything was written
