"""Checkpoints of trees of tensors and of training state (port of
``ocm_tpu/utils/checkpoint.py``).

The JAX package checkpoints with Orbax, which the port does not depend
on; an Orbax directory written by ``ocm_tpu`` is not readable here.  The
port's own format:

- ``save_pytree``/``load_pytree``: one file in the msgpack format of
  ``utils/msgpack_io.py`` (flax's; the model files of both packages use
  it), for any tree of dicts, lists and tuples of tensors, arrays and
  scalars, e.g. a ``state_dict``;
- ``TrainCheckpointer``: versioned epoch directories ``epoch_<n>/`` each
  holding the model ``state_dict`` (``model.msgpack``), the Adam
  ``state_dict`` (``opt.msgpack``) and the epoch, for a true mid-training
  resume through ``train_vae(..., init_state=(state, opt_state),
  epoch_offset=epoch)``.  Each directory is written under a temporary name
  and renamed into place, so a crash never leaves a half-written epoch;
  the oldest past ``max_to_keep`` are deleted.
"""

from __future__ import annotations

import os
import re
import shutil
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

from ocm_tpu_torch.utils import msgpack_io


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            raise ValueError("bfloat16 tensors have no numpy dtype; cast "
                             "them before saving")
        return tree.detach().cpu().numpy()
    if isinstance(tree, Mapping):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _like(value, template):
    """``value`` (as read back) in the structure, types and devices of
    ``template``."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.asarray(value), dtype=template.dtype,
                               device=template.device)
    if isinstance(template, Mapping):
        if set(value) != set(template):
            raise ValueError(f"checkpoint keys {sorted(map(str, value))} "
                             "do not match the template's "
                             f"{sorted(map(str, template))}")
        return type(template)((k, _like(value[k], v))
                              for k, v in template.items())
    if isinstance(template, (list, tuple)):
        if len(value) != len(template):
            raise ValueError(f"checkpoint sequence of {len(value)} entries, "
                             f"template of {len(template)}")
        return type(template)(_like(v, t) for v, t in zip(value, template))
    if isinstance(template, np.ndarray):
        return np.asarray(value, dtype=template.dtype)
    return value


def _to_tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v) for v in tree)
    return tree


def save_pytree(path: str, tree: Any) -> str:
    """Write a tree (dicts, lists and tuples of tensors, arrays and
    scalars) to one msgpack file, keys in their own order.  Returns the
    absolute path."""
    path = os.path.abspath(path)
    msgpack_io.save(path, _to_numpy(tree), sort_keys=False)
    return path


def load_pytree(path: str, template: Any = None) -> Any:
    """The tree saved by ``save_pytree``: with ``template`` (an object of
    the same structure, e.g. an untrained model's ``state_dict``) in its
    structure, dtypes and devices; without one, dicts and lists of CPU
    tensors."""
    tree = msgpack_io.load(os.path.abspath(path))
    return _to_tensors(tree) if template is None else _like(tree, template)


class TrainCheckpointer:
    """Versioned training checkpoints: model ``state_dict``, Adam
    ``state_dict`` and epoch, one directory an epoch, the newest
    ``max_to_keep`` kept."""

    _PATTERN = re.compile(r"^epoch_(\d+)$")

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{int(epoch)}")

    def epochs(self) -> list[int]:
        """The saved epochs, oldest first."""
        found = (self._PATTERN.match(name)
                 for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, epoch: int, state: Mapping, opt_state: Mapping) -> str:
        """Write ``epoch``'s model and optimizer ``state_dict``s (a
        ``TrainResult``'s ``final_state`` and ``final_opt_state``), then
        delete the oldest epochs past ``max_to_keep``.  Returns the
        epoch's directory."""
        final = self._path(epoch)
        tmp = os.path.join(self.directory,
                           f".tmp_epoch_{int(epoch)}_{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_pytree(os.path.join(tmp, "model.msgpack"), dict(state))
        save_pytree(os.path.join(tmp, "opt.msgpack"), dict(opt_state))
        save_pytree(os.path.join(tmp, "meta.msgpack"), {"epoch": int(epoch)})
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.epochs()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old))
        return final

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, epoch: Optional[int] = None, model_template=None):
        """(state_dict, optimizer state_dict, epoch) of ``epoch`` (the
        latest by default), or None when nothing is saved.  With
        ``model_template`` (a model's ``state_dict``) the model state comes
        back in its dtypes and on its device; otherwise as CPU tensors,
        which ``load_state_dict`` copies into place."""
        epoch = self.latest_epoch() if epoch is None else int(epoch)
        if epoch is None:
            return None
        path = self._path(epoch)
        state = load_pytree(os.path.join(path, "model.msgpack"),
                            model_template)
        opt = load_pytree(os.path.join(path, "opt.msgpack"))
        meta = load_pytree(os.path.join(path, "meta.msgpack"))
        return state, opt, int(meta["epoch"])

    def close(self) -> None:
        """Nothing is held open between calls (saves are synchronous)."""

