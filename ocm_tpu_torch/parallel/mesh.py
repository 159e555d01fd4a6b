"""Rank meshes on ``torch.distributed`` and the sharding helpers (port of
``ocm_tpu/parallel/mesh.py``).

A ``Mesh`` is the world's ranks laid out in ``shape``: rank r sits at the
C-order position r of ``np.arange(world).reshape(shape)``, as JAX lays out
its devices, and each axis has one process group per line of ranks along
it.  ``make_mesh`` builds every group on every rank in one order (each
rank must call ``torch.distributed.new_group`` for every group, or the
run hangs).  ``mesh.shape[axis]`` and ``mesh.axis_names`` read as JAX's
do; ``mesh.device`` is this rank's device (CUDA unless the caller names
another).  A mesh of size 1 needs no process group, and then its
collectives are the identity (the reference: "meshes of size 1 work");
inside a one-rank group they run through it.  An axis of size 1 in a
larger world has no group and reduces nothing.

Collectives.  The reference's ``psum`` is ``Mesh.psum``, an all-reduce, and
its tiled ``all_gather`` is ``Mesh.all_gather``: an all-reduce of a zero
buffer in which each rank has written its own slot, which is exact
(x + 0 = x).  Every collective is an ``all_reduce``, so one code runs on
NCCL, on gloo with CUDA tensors (whose CUDA support is certain only for
``all_reduce`` and ``broadcast``) and on gloo on the CPU; none copies to
the host.  Booleans travel as uint8.

Outputs of the sharded entry points (``simca_dist``, ``train_dist``,
``sweep_dist``):

- what the reference returns replicated (models, limits, CV tables,
  ``TrainResult``s, losses) is the full value on every rank;
- what it returns sharded along samples (``predict_sharded``'s
  ``(accept, dred, t2, q)``) is this rank's rows, with no collective.

Inputs are what the reference takes, global arrays; each rank moves only
its own rows to its device.

``with mesh.recording(sink):`` appends one text line to the list ``sink``
for each collective issued (``"<op> axis=<axis> what=<what> dtype=<dtype>
shape=<shape> bytes=<n>"``, the all-reduce's buffer) and for each input a
rank took its rows of (``"shard axis=<axis> what=<what> local=<shape>
global=<shape>"``): the counterpart of the compiled HLO that
``ocm_tpu``'s ``hlo_sink`` captures.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ocm_tpu_torch._device import as_tensor, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class _Leaf:
    """A gathered leaf's slot in ``Mesh.all_gather_tree``'s skeleton."""

    def __init__(self, index: int, numpy: bool):
        self.index, self.numpy = index, numpy


class Mesh:
    """This rank's view of a rank mesh: its coordinates, its device and the
    process group of each axis line it lies on (None where the line is
    this rank alone outside a one-rank world, whose collectives are the
    identity).  Build it with ``make_mesh``."""

    def __init__(self, shape, axis_names, device, rank: int, groups: dict):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = int(np.prod(shape))
        self.rank = rank
        self.device = device
        self._coords = dict(zip(self.axis_names, (int(c) for c in
                                                  np.unravel_index(rank,
                                                                   shape))))
        self._groups = groups
        self._sink = None

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"device={self.device})")

    def axis_index(self, axis: str) -> int:
        """This rank's position along ``axis`` (JAX's ``axis_index``)."""
        return self._coords[axis]

    def rows(self, n: int, axis: str) -> slice:
        """This rank's block of ``n`` rows sharded over ``axis``."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(
                f"sample count {n} not divisible by mesh axis {axis!r} of "
                f"size {size}; pad the batch first")
        per = n // size
        i = self.axis_index(axis)
        return slice(i * per, (i + 1) * per)

    @contextlib.contextmanager
    def recording(self, sink: Optional[list]):
        """Append a record of each collective and shard to ``sink`` (a list;
        None records nothing) while the block runs."""
        prev, self._sink = self._sink, sink if sink is not None else self._sink
        try:
            yield sink
        finally:
            self._sink = prev

    def note_shard(self, what: str, axis: str, local, global_shape):
        if self._sink is not None:
            self._sink.append(f"shard axis={axis} what={what} "
                              f"local={tuple(local)} "
                              f"global={tuple(global_shape)}")

    def _all_reduce(self, buf, axis: str, op: str, what: str):
        if self._groups[axis] is None:
            return buf
        if self._sink is not None:
            self._sink.append(
                f"{op} axis={axis} what={what} "
                f"dtype={str(buf.dtype).replace('torch.', '')} "
                f"shape={tuple(buf.shape)} "
                f"bytes={buf.numel() * buf.element_size()}")
        dist.all_reduce(buf, group=self._groups[axis])
        return buf

    def psum(self, x, axis: str, what: str = "sum"):
        """Sum over ``axis`` (the reference's ``jax.lax.psum``): ``x`` a
        tensor, or a sequence of tensors of one dtype, reduced in one
        round and returned as a list."""
        if self._groups[axis] is None:
            return x if isinstance(x, torch.Tensor) else list(x)
        if isinstance(x, torch.Tensor):
            return self._all_reduce(x.contiguous().clone(), axis,
                                    "all-reduce", what)
        flat = self._all_reduce(torch.cat([t.reshape(-1) for t in x]), axis,
                                "all-reduce", what)
        return [p.view(t.shape) for p, t in
                zip(flat.split([t.numel() for t in x]), x)]

    def all_gather(self, x, axis: str, what: str = "gather", dim: int = 0):
        """Tiled all-gather over ``axis`` along ``dim`` (``jax.lax.all_gather
        (..., tiled=True)``); every rank's block must have one shape."""
        size = self.shape[axis]
        if self._groups[axis] is None:
            return x
        is_bool = x.dtype == torch.bool
        src = x.to(torch.uint8) if is_bool else x
        dim = dim % src.dim()
        n = src.shape[dim]
        full = list(src.shape)
        full[dim] = n * size
        buf = src.new_zeros(full)
        buf.narrow(dim, self.axis_index(axis) * n, n).copy_(src)
        self._all_reduce(buf, axis, "all-gather", what)
        return buf.to(torch.bool) if is_bool else buf

    def all_gather_tree(self, tree, axis: str, what: str = "gather"):
        """``all_gather`` along the leading axis of every tensor and numpy
        leaf of a tree of dicts, tuples and lists, one round a dtype;
        other leaves (ints, floats, None) are shared and kept."""
        leaves = []

        def collect(t):
            if isinstance(t, dict):
                return {k: collect(v) for k, v in t.items()}
            if isinstance(t, tuple) and hasattr(t, "_fields"):
                return type(t)(*(collect(v) for v in t))
            if isinstance(t, (tuple, list)):
                return type(t)(collect(v) for v in t)
            if isinstance(t, np.ndarray):
                leaves.append(torch.from_numpy(np.ascontiguousarray(t))
                              .to(self.device))
                return _Leaf(len(leaves) - 1, True)
            if isinstance(t, torch.Tensor):
                leaves.append(t)
                return _Leaf(len(leaves) - 1, False)
            return t

        skeleton = collect(tree)
        gathered = [None] * len(leaves)
        by_dtype: dict = {}
        for i, t in enumerate(leaves):
            by_dtype.setdefault(t.dtype, []).append(i)
        for dtype, idx in by_dtype.items():
            parts = [leaves[i].reshape(leaves[i].shape[0], -1) for i in idx]
            full = self.all_gather(torch.cat(parts, 1), axis,
                                   f"{what}:{str(dtype).replace('torch.', '')}")
            cols = full.split([p.shape[1] for p in parts], 1)
            for i, c in zip(idx, cols):
                gathered[i] = c.reshape(-1, *leaves[i].shape[1:])

        def rebuild(t):
            if isinstance(t, dict):
                return {k: rebuild(v) for k, v in t.items()}
            if isinstance(t, tuple) and hasattr(t, "_fields"):
                return type(t)(*(rebuild(v) for v in t))
            if isinstance(t, (tuple, list)):
                return type(t)(rebuild(v) for v in t)
            if isinstance(t, _Leaf):
                g = gathered[t.index]
                return g.cpu().numpy() if t.numpy else g
            return t

        return rebuild(skeleton)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              device=None) -> Mesh:
    """Lay the world's ranks out in ``shape`` (default: one data axis over
    all ranks) and build each axis line's process group.

    ``shape`` must multiply to the world size (1 without an initialized
    process group).  ``device`` is this rank's device: by default CUDA, the
    current device (``torch.cuda.set_device`` it first where ranks have
    cards of their own).  Every rank must call ``make_mesh`` with the same
    shape and names.
    """
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         "differ in length")
    if int(np.prod(shape)) != world:
        raise ValueError(
            f"mesh shape {shape} != {world} ranks" + (
                "" if initialized else " (no process group is initialized;"
                " call torch.distributed.init_process_group first)"))
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ranks = np.arange(world).reshape(shape)
    groups = {}
    for a, name in enumerate(axis_names):
        if initialized and shape[a] == world:
            groups[name] = dist.group.WORLD
        elif shape[a] == 1:
            groups[name] = None
        else:
            for line in np.moveaxis(ranks, a, -1).reshape(-1, shape[a]):
                members = [int(r) for r in line]
                group = dist.new_group(members)
                if rank in members:
                    groups[name] = group
    return Mesh(shape, axis_names, device, rank, groups)


def require_mesh_axis(mesh: Mesh, axis: str) -> None:
    """Raise a uniform error when ``mesh`` is not a port ``Mesh`` or
    ``axis`` is not one of its axes (shared guard for every sharded entry
    point and ``mesh=`` hook)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            "mesh must be an ocm_tpu_torch.parallel.mesh.Mesh (build one "
            f"with make_mesh), got {type(mesh).__name__}")
    if axis not in mesh.shape:
        raise ValueError(
            f"mesh has no axis {axis!r} (axes: "
            f"{tuple(mesh.axis_names)}); build one with "
            f"make_mesh((n,), ({axis!r},)) or pass the axis name")


def shard_batch(x, mesh: Mesh, axis: str = DATA_AXIS, what: str = "x"):
    """This rank's rows of an (N, ...) array with its sample axis sharded
    over ``mesh[axis]``, on the mesh's device (``_device.as_tensor``'s
    dtype rule).  N must divide evenly by the axis size (pad upstream)."""
    sl = mesh.rows(x.shape[0], axis)
    if isinstance(x, torch.Tensor):
        local = x[sl].to(mesh.device)
    else:
        local = as_tensor(np.asarray(x)[sl], mesh.device)
    mesh.note_shard(what, axis, local.shape, x.shape)
    return local


def cyclic_pad(arrays, multiple: int):
    """Pad each array's leading axis to a multiple by cyclic repetition.

    Maps an arbitrary unit count (CV folds, class x fold cells, HPO
    configs) onto a mesh axis: padded units are repeats of real ones, so
    they compute real (discarded) results instead of degenerate masks.
    Returns ``(padded_arrays, pad)``; callers drop the last ``pad`` rows
    of every output.  numpy arrays stay numpy, tensors stay tensors.
    """
    n = arrays[0].shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return list(arrays), 0
    return [cyclic_pad_to(a, n + pad) for a in arrays], pad


def cyclic_pad_to(a, n: int):
    """Extend an array's leading axis to exactly ``n`` rows by verbatim
    cyclic repetition (the pad-to-size sibling of ``cyclic_pad``)."""
    if a.shape[0] == n:
        return a
    idx = np.arange(n) % a.shape[0]
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, device=a.device)]
    return a[idx]


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad with repeated last rows to a multiple; returns (padded, n_true)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_widths = [(0, 0)] * x.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(np.asarray(x), pad_widths, mode="edge"), n
