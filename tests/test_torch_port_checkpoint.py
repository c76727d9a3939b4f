"""``save_checkpoint`` writes all or nothing.

A write that fails part-way (here ``torch.save`` writes some bytes and then
raises ``ENOSPC``, as a full disk does) propagates its error, leaves no
``<path>.tmp`` behind and leaves an earlier checkpoint under the final name
as it was; a write that succeeds leaves exactly the final file.
"""

import errno
import os
import shutil

import pytest
import torch

from skghoi_torch.train import checkpoint
from skghoi_torch.train.checkpoint import load_checkpoint, save_checkpoint


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed when the test ends, passed or failed:
    pytest keeps the directories of its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 3, generator=g), "b": torch.randn(3, generator=g)}


def _save(path, seed, epoch):
    save_checkpoint(str(path), _state(seed), {"state": {}, "param_groups": []}, epoch, 2 * epoch)


@pytest.mark.parametrize("partial", [True, False], ids=["partial-write", "no-write"])
def test_failed_write_leaves_no_tmp_and_the_old_checkpoint(tmp_path, monkeypatch, partial):
    path = tmp_path / "ckpt_01.pt"
    _save(path, seed=0, epoch=1)
    before = path.read_bytes()

    def full_disk(obj, f):
        if partial:
            with open(f, "wb") as fh:
                fh.write(b"\0" * 4096)
        raise OSError(errno.ENOSPC, os.strerror(errno.ENOSPC), str(f))

    monkeypatch.setattr(checkpoint.torch, "save", full_disk)
    with pytest.raises(OSError) as err:
        _save(path, seed=1, epoch=2)
    assert err.value.errno == errno.ENOSPC
    monkeypatch.undo()

    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_01.pt"]
    assert path.read_bytes() == before
    ckpt = load_checkpoint(str(path))
    assert ckpt["epoch"] == 1 and ckpt["iteration"] == 2
    for k, v in _state(0).items():
        assert torch.equal(ckpt["model_state_dict"][k], v), k


def test_successful_write_leaves_only_the_checkpoint(tmp_path):
    path = tmp_path / "ckpt_01.pt"
    _save(path, seed=0, epoch=1)
    _save(path, seed=1, epoch=2)  # over an earlier checkpoint
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_01.pt"]
    ckpt = load_checkpoint(str(path))
    assert set(ckpt) == {"model_state_dict", "optim_state_dict", "scheduler_state_dict",
                         "epoch", "iteration"}
    assert ckpt["epoch"] == 2 and ckpt["scheduler_state_dict"] == {"step": 4}
    for k, v in _state(1).items():
        assert torch.equal(ckpt["model_state_dict"][k], v), k
