"""Resume from a corrupt checkpoint, as the JAX package does
(tests/test_train_smoke.py::test_checkpoint_corruption_fallback): a torn
``latest.ckpt`` and a ``CKPT_VERSION`` from the future both fall back to the
newest readable numbered checkpoint, for ``load_model`` (resume) and
``load_network`` (eval); with nothing readable, ``load_model`` starts fresh
and ``load_network`` raises. Both packages pick the same file from the same
directory. The port's ``load_pretrain`` refuses a missing ``pretrain.ckpt``
where JAX's returns None."""

import os
import pickle

import pytest
import torch

from nerf_replication_tpu.utils import ckpt_utils as jax_ckpt
from nerf_replication_tpu_torch.utils import ckpt_utils


def _net(value: float) -> torch.nn.Linear:
    layer = torch.nn.Linear(2, 1)
    with torch.no_grad():
        layer.weight.fill_(value)
        layer.bias.fill_(value)
    return layer


def _saved(directory: str) -> None:
    """3.ckpt, 4.ckpt and a latest.ckpt of epoch 5, each net's bias equal
    to its epoch."""
    for epoch in (3, 4):
        ckpt_utils.save_model(_net(epoch), {}, {"step": epoch}, {}, epoch,
                              directory)
    ckpt_utils.save_model(_net(5), {}, {"step": 5}, {}, 5, directory,
                          latest=True)


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _bias(tree: dict) -> float:
    return float(tree["params"]["bias"][0])


def _both_epochs(directory: str) -> tuple:
    """(port's load_model epoch, JAX's load_model epoch, port's
    load_network bias)."""
    ours = ckpt_utils.load_model(directory)
    theirs = jax_ckpt.load_model(directory, resume=True)
    return (ours and ours["epoch"], theirs and theirs["epoch"],
            _bias(ckpt_utils.load_network(directory)) if ours else None)


def test_corrupt_latest_falls_back_to_newest_readable(tmp_path):
    d = str(tmp_path / "m")
    _saved(d)
    assert _both_epochs(d) == (5, 5, 5.0)

    _write(os.path.join(d, "latest.ckpt"), b"not a pickle")      # torn
    assert _both_epochs(d) == (4, 4, 4.0)

    _write(os.path.join(d, "4.ckpt"), b"\x00" * 10)              # truncated
    assert _both_epochs(d) == (3, 3, 3.0)

    with open(os.path.join(d, "latest.ckpt"), "wb") as f:        # future
        pickle.dump({"version": ckpt_utils.CKPT_VERSION + 1, "net": {},
                     "epoch": 9}, f)
    assert _both_epochs(d) == (3, 3, 3.0)
    # an explicit epoch has no fallback
    with pytest.raises(FileNotFoundError):
        ckpt_utils.load_network(d, epoch=4)

    for name in ("3.ckpt", "latest.ckpt"):
        _write(os.path.join(d, name), b"x")
    assert ckpt_utils.load_model(d) is None
    assert jax_ckpt.load_model(d, resume=True) is None
    with pytest.raises(FileNotFoundError):
        ckpt_utils.load_network(d)


def test_truncated_latest_resumes_optimizer_state(tmp_path):
    """A latest.ckpt cut mid-write (its first half) resumes from the
    newest numbered checkpoint with that checkpoint's optimizer state."""
    d = str(tmp_path / "m")
    net = _net(1.0)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    net(torch.ones(1, 2)).sum().backward()
    opt.step()
    ckpt_utils.save_model(net, opt.state_dict(), {"step": 1}, {"step": 1},
                          0, d)
    path = ckpt_utils.save_model(_net(2.0), {}, {"step": 2}, {}, 1, d,
                                 latest=True)
    with open(path, "rb") as f:
        data = f.read()
    _write(path, data[: len(data) // 2])
    payload = ckpt_utils.load_model(d)
    assert payload["epoch"] == 0 and payload["scheduler"] == {"step": 1}
    moments = payload["optim"]["state"][0]
    assert torch.equal(moments["exp_avg"], opt.state_dict()["state"][0][
        "exp_avg"])


def test_missing_pretrain_raises_where_jax_returns_none(tmp_path):
    missing = str(tmp_path / "nowhere")
    assert jax_ckpt.load_pretrain(missing) is None
    with pytest.raises(FileNotFoundError):
        ckpt_utils.load_pretrain(missing)
