"""Checkpoint I/O for the port, in the JAX package's format.

The JAX package writes checkpoints as pickles of plain numpy trees
(nerf_replication_tpu/utils/ckpt_utils.py:76-178): ``{version, net, optim,
scheduler, recorder, epoch}`` under ``<trained_model_dir>/{N,latest}.ckpt``
with the 5 newest numbered files kept, and ``{"net": params}`` in
``<dir>/pretrain.ckpt``. These read and write them without JAX:
:func:`params_from_jax` turns a NeRF params tree into the port's
state_dict and :func:`params_to_jax` back, so each package's
``load_network`` reads the other's checkpoints. ``optim`` holds the torch
optimizer's state as numpy arrays. Only checkpoints this project wrote
should be loaded: unpickling runs code.
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
import sys

import numpy as np
import torch


CKPT_VERSION = 1   # the JAX package's payload schema


def _load_payload(path: str) -> dict:
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if not isinstance(payload, dict) or "net" not in payload:
        raise ValueError(f"malformed checkpoint payload: {path}")
    if int(payload.get("version", 0)) > CKPT_VERSION:
        raise ValueError(f"checkpoint {path} has version "
                         f"{payload['version']} > supported {CKPT_VERSION}")
    return payload


def _load_net(path: str) -> dict:
    payload = _load_payload(path)
    print(f"load network: {path}")
    return payload["net"]


def load_pretrain(directory: str) -> dict:
    """The params tree of ``<directory>/pretrain.ckpt``. Raises when it is
    missing, where the JAX package returns None and trains from init: a
    pretrain the config names is not silently dropped."""
    path = os.path.join(directory, "pretrain.ckpt")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no pretrain.ckpt under {directory}")
    return _load_net(path)


def _numbered(names) -> list[int]:
    return sorted(int(p[:-5]) for p in names
                  if p.endswith(".ckpt") and p[:-5].isdigit())


def _pick(model_dir: str, epoch: int = -1) -> str:
    """``<model_dir>/<epoch>.ckpt``, or with ``epoch`` -1 ``latest.ckpt``,
    else the highest-numbered checkpoint; raises if there is none."""
    names = os.listdir(model_dir) if os.path.isdir(model_dir) else []
    numbered = _numbered(names)
    if epoch != -1:
        name = f"{epoch}.ckpt"
    elif "latest.ckpt" in names:
        name = "latest.ckpt"
    elif numbered:
        name = f"{numbered[-1]}.ckpt"
    else:
        name = None
    if name is None or name not in names:
        raise FileNotFoundError(f"no checkpoint under {model_dir}")
    return os.path.join(model_dir, name)


def _candidates(model_dir: str, epoch: int = -1) -> list[str]:
    """:func:`_pick`'s choice first, then (with ``epoch`` -1) the numbered
    checkpoints newest first, as fallbacks for a corrupt one: the atomic
    rename protects one file, not a half-written disk. Empty when there
    is no checkpoint."""
    try:
        first = _pick(model_dir, epoch)
    except FileNotFoundError:
        return []
    if epoch != -1:
        return [first]
    numbered = (os.path.join(model_dir, f"{e}.ckpt")
                for e in reversed(_numbered(os.listdir(model_dir))))
    return [first, *(p for p in numbered if p != first)]


def _load_first_valid(model_dir: str, epoch: int = -1):
    """(path, payload) of the first readable of :func:`_candidates`, or
    (None, None). A truncated file, a foreign pickle or a newer
    ``CKPT_VERSION`` counts as unreadable."""
    for path in _candidates(model_dir, epoch):
        try:
            return path, _load_payload(path)
        except Exception as e:   # noqa: BLE001 - any unreadable file
            print(f"checkpoint {path} unreadable ({e}); trying previous",
                  file=sys.stderr)
    return None, None


def load_network(model_dir: str, epoch: int = -1) -> dict:
    """The params tree of the first readable checkpoint of
    :func:`_candidates`; raises FileNotFoundError when there is none."""
    path, payload = _load_first_valid(model_dir, epoch)
    if payload is None:
        raise FileNotFoundError(f"no readable checkpoint under {model_dir}")
    print(f"load network: {path}")
    return payload["net"]


def _to_numpy(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return tree


def save_model(network, optim_state: dict, scheduler_state: dict,
               recorder_state: dict, epoch: int, model_dir: str,
               latest: bool = False, keep: int = 5) -> str:
    """Write ``<model_dir>/{epoch,latest}.ckpt`` with the JAX payload keys
    (``net`` in the Flax layout, ``optim`` as numpy arrays) atomically,
    then keep the ``keep`` newest numbered checkpoints. Returns the path."""
    os.makedirs(model_dir, exist_ok=True)
    payload = {
        "version": CKPT_VERSION,
        "net": params_to_jax(network.state_dict()),
        "optim": _to_numpy(optim_state),
        "scheduler": dict(scheduler_state),
        "recorder": dict(recorder_state),
        "epoch": int(epoch),
    }
    path = os.path.join(model_dir, "latest.ckpt" if latest
                        else f"{epoch}.ckpt")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)
    for e in _numbered(os.listdir(model_dir))[:-keep]:
        os.remove(os.path.join(model_dir, f"{e}.ckpt"))
    return path


def load_model(model_dir: str, resume: bool = True, epoch: int = -1):
    """The checkpoint payload to resume from (``optim`` back as tensors),
    or None for a fresh start; ``resume`` False wipes ``model_dir``. A
    corrupt ``latest.ckpt`` falls back to the newest readable numbered
    checkpoint, as in the JAX package (:func:`_load_first_valid`)."""
    if not resume:
        if os.path.exists(model_dir):
            print(f"remove contents of directory {model_dir}")
            shutil.rmtree(model_dir, ignore_errors=True)
        return None
    path, payload = _load_first_valid(model_dir, epoch)
    if payload is None:
        return None
    print(f"load model: {path}")
    payload["optim"] = _to_torch(payload["optim"])
    return payload


# a Flax list submodule's name (``pts_3``, ``basis_0``, ``time_mlp_4``)
_INDEXED = re.compile(r"^(.+)_(\d+)$")


def _f32(array) -> torch.Tensor:
    """A float32 copy, C-contiguous."""
    return torch.from_numpy(np.array(array, dtype=np.float32, order="C"))


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """A Flax params tree ``{"params": {...}}`` (numpy) -> the port's
    state_dict, at any depth: a Dense ``{kernel (in, out), bias}`` becomes
    ``.weight`` (out, in) and ``.bias``, so every kernel is transposed; a
    submodule named as a Flax list item (``pts_3``, ``mlp_0``, ``basis_2``,
    ``time_mlp_4``) becomes the ``nn.ModuleList`` key (``pts.3``, ...); a
    leaf that is an array itself (a hash-grid table, ``latent_t``,
    ``st_feat_1``) keeps its name and layout."""
    state = {}

    def walk(node: dict, prefix: str):
        if "kernel" in node:
            state[f"{prefix}weight"] = _f32(np.asarray(node["kernel"]).T)
            state[f"{prefix}bias"] = _f32(node["bias"])
            return
        for name, child in node.items():
            if not isinstance(child, dict):
                state[prefix + name] = _f32(child)
                continue
            m = _INDEXED.match(name)
            walk(child, prefix + (f"{m[1]}.{m[2]}." if m else f"{name}."))

    walk(tree["params"], "")
    return state


def params_to_jax(state: dict) -> dict:
    """The inverse of :func:`params_from_jax`: a port state_dict -> the
    Flax params tree (numpy float32, kernels (in, out), other parameters
    as they are, ``nn.ModuleList`` keys back to Flax list names)."""
    tree: dict = {"params": {}}
    for key, value in state.items():
        arr = value.detach().cpu().float().numpy()
        parts = key.split(".")
        names = []                      # mlp.0 -> mlp_0
        for part in parts[:-1]:
            if part.isdigit():
                names[-1] = f"{names[-1]}_{part}"
            else:
                names.append(part)
        node = tree["params"]
        for name in names:
            node = node.setdefault(name, {})
        leaf = parts[-1]
        if leaf == "weight":
            node["kernel"] = np.ascontiguousarray(arr.T)
        elif leaf == "bias":
            node["bias"] = arr.copy()
        else:                           # e.g. xyz_encoder.table
            node[leaf] = arr.copy()
    return tree
