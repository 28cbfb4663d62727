"""The (data, model, seq) grid of torch devices the sharded match runs on.

The port of ``swarm_tpu/parallel/mesh.py``. Axes:

- ``data``: target rows; no traffic between data ranks until the rows'
  planes are gathered;
- ``model``: hash-table groups; every rank probes the same windows
  against its 1/R slice of each table's sorted h1 range, and the slot
  bits of the ranks combine by OR;
- ``seq``: the response's bytes; each rank scans its slice of the row
  with halos of the longest table entry borrowed from both neighbours.

``make_mesh`` lays ranks out as the reference does: from a slice shape
(``SWARM_SLICE_SHAPE``; GPUs have no physical coordinates, so
``detect_slice_shape`` finds none on its own) or by
:func:`factor_devices`. The grid is held by :class:`Mesh`, a numpy
object array of ``torch.device``. A device may appear more than once:
every rank of a grid over ``["cpu"] * 8`` or ``["cuda:0"] * 8`` runs on
that one device, which is how a grid is tested on the CPU and on a
single card; with distinct GPUs the placement is the reference's.

One process drives every rank of its own (the reference's one controller
for every local chip): the sharded matcher launches each rank's kernels
on its rank's device and that device's current stream. In a process
group (``parallel/multihost.py``) the grid spans every process's
devices, and ``Mesh.process`` says which process drives each rank.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

AXES = ("data", "model", "seq")


def factor_devices(n: int) -> tuple[int, int, int]:
    """Split n devices into (data, model, seq) — favor data, then
    model. The topology-blind fallback (no coords, no env hint)."""
    if n <= 1:
        return (1, 1, 1)
    seq = 2 if n % 2 == 0 and n >= 8 else 1
    rem = n // seq
    model = 2 if rem % 2 == 0 and rem >= 4 else 1
    data = rem // model
    return (data, model, seq)


def slice_layout(
    phys: tuple[int, ...]
) -> tuple[tuple[int, int, int], tuple[int, ...]]:
    """Map a physical slice shape onto the (data, model, seq) mesh.

    Returns ``(mesh_shape, axis_perm)``: ``axis_perm`` orders the
    physical axes as (data..., model, seq) so that a transpose+reshape
    of the coordinate-ordered device grid keeps each communicating
    mesh axis on ONE physical axis.

    Policy: the two *smallest* >1 physical axes carry the
    communicating meshes — ``model`` (the heavier combine) gets the
    larger of the two, ``seq`` the smaller — and everything else
    multiplies into ``data`` (no communication, so straddling axes is
    free). Examples: (2,2,1) → (2, 2, 1); (4,2,2) → (4, 2, 2); (4,4) →
    (4, 4, 1).
    """
    dims = [(d, i) for i, d in enumerate(phys)]
    nontrivial = sorted((d, i) for d, i in dims if d > 1)
    model = seq = None
    if len(nontrivial) >= 3:
        # two smallest carry comm; model = the larger of those two
        seq = nontrivial[0]
        model = nontrivial[1]
    elif len(nontrivial) == 2:
        model = nontrivial[0]
    elif len(nontrivial) == 1:
        # a 1-D slice: everything is one ring; keep it all data
        pass
    data_axes = [
        i for _d, i in dims
        if (model is None or i != model[1]) and (seq is None or i != seq[1])
    ]
    perm = tuple(
        data_axes
        + ([model[1]] if model else [])
        + ([seq[1]] if seq else [])
    )
    data = 1
    for i in data_axes:
        data *= phys[i]
    shape = (data, model[0] if model else 1, seq[0] if seq else 1)
    return shape, perm


def _env_slice_shape() -> Optional[tuple[int, ...]]:
    raw = os.environ.get("SWARM_SLICE_SHAPE", "").strip().lower()
    if not raw:
        return None
    try:
        dims = tuple(int(p) for p in raw.replace("*", "x").split("x"))
    except ValueError:
        return None
    return dims if dims and all(d >= 1 for d in dims) else None


def detect_slice_shape(devices: Sequence) -> Optional[tuple[int, ...]]:
    """Physical slice shape: the ``SWARM_SLICE_SHAPE`` hint when it
    covers exactly these devices, else device ``.coords``, which no
    torch device has → None."""
    env = _env_slice_shape()
    if env is not None:
        return env if int(np.prod(env)) == len(devices) else None
    coords = [getattr(d, "coords", None) for d in devices]
    if any(c is None for c in coords):
        return None
    arr = np.asarray(coords)
    if arr.ndim != 2:
        return None
    shape = tuple(int(m) + 1 for m in arr.max(axis=0))
    n = int(np.prod(shape))
    if n != len(devices) or len({tuple(c) for c in coords}) != n:
        return None
    return shape


class Mesh:
    """A grid of torch devices: ``devices`` an object array of
    ``torch.device`` shaped by the axes, ``process`` the rank of the
    process that drives each entry (all 0 in one process), ``axis_names``
    the axes, and ``shape`` each axis's size by name (as a JAX ``Mesh``
    gives them)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = AXES,
                 process: Optional[np.ndarray] = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d grid for axes {tuple(axis_names)}")
        if process is None:
            process = np.zeros(devices.shape, dtype=np.int64)
        if process.shape != devices.shape:
            raise ValueError("process must have the grid's shape")
        self.devices = devices
        self.process = process
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self) -> str:
        procs = sorted({int(p) for p in self.process.flat})
        return f"Mesh({self.shape}, {sorted({str(d) for d in self.devices.flat})}, process {procs})"


def _grid(devices: Sequence) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr


def local_devices() -> list:
    """Every local CUDA device; raises without one."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device: pass devices (e.g. ['cpu'] * 8) to make_mesh")
    return [torch.device(f"cuda:{i}") for i in range(n)]


def make_mesh(
    shape: Optional[tuple[int, int, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """The (data, model, seq) mesh over ``devices`` (default: every
    local CUDA device). In a process group of several processes
    (``parallel/multihost.py``), ``devices`` are this process's own, and
    the mesh spans every process's, in process order, as
    ``jax.devices()`` orders them: each process's list is gathered
    (``all_gather_object``; every process calls ``make_mesh`` alike) and
    ``Mesh.process`` says which process drives each entry. Without
    ``shape``, a slice shape lays the grid out by :func:`slice_layout`,
    else :func:`factor_devices` splits the device count; with one, its
    first data × model × seq devices fill the grid in order."""
    from swarm_tpu_torch.parallel import multihost

    devices = list(devices) if devices is not None else local_devices()
    per_process = multihost.gather_objects([str(torch.device(d)) for d in devices])
    devices = [d for names in per_process for d in names]
    procs = np.array([p for p, names in enumerate(per_process) for _ in names], dtype=np.int64)
    if shape is None:
        phys = detect_slice_shape(devices)
        if phys is not None:
            mesh_shape, perm = slice_layout(phys)

            def lay(grid):
                return np.ascontiguousarray(grid.reshape(phys).transpose(perm)).reshape(mesh_shape)

            return Mesh(lay(_grid(devices)), AXES, lay(procs))
        shape = factor_devices(len(devices))
    data, model, seq = shape
    count = data * model * seq
    if count > len(devices):
        raise ValueError(f"mesh {shape} needs {count} devices, have {len(devices)}")
    return Mesh(_grid(devices[:count]).reshape(data, model, seq), AXES,
                procs[:count].reshape(data, model, seq))
