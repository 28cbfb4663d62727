"""Multi-host initialization: one ``torch.distributed`` process group for
a mesh across processes and hosts.

The port of ``swarm_tpu/parallel/multihost.py``. The reference keeps the
HTTP control plane of its workers and, for a worker that spans several
hosts, joins the JAX distributed runtime so one mesh spans every chip.
Here the worker processes join one ``torch.distributed`` group, and
``parallel/mesh.py`` lays a mesh over every process's devices.

Opt-in via environment (nothing happens on single-host workers):

    SWARM_COORDINATOR=host:port   the rank-0 worker's address
    SWARM_NUM_PROCESSES=N         total participating worker processes
    SWARM_PROCESS_ID=K            this worker's rank (0-based)

``autodetect=True`` stands for JAX's cluster autodetection: it reads
torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
when the triplet is absent.

The group is first joined with ``gloo``. The processes then exchange
which devices their ranks run on (``all_gather_object``), and the
backend of the sharded match's collectives is chosen from them:

- ``gloo`` when any process runs its ranks on the CPU;
- ``gloo``, each collective staged through host memory, when two
  processes share a card: NCCL refuses two ranks on one GPU;
- ``nccl`` when each process has its own cards: an NCCL group over the
  same processes.

The choice is printed, kept here (:func:`collective_backend`) and
exported as ``SWARM_DIST_BACKEND``. A failed init, or a failed NCCL
group, raises: no other backend is put in its place.
"""

from __future__ import annotations

import os
import socket
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist

#: torchrun's environment, read by ``autodetect``
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

#: the backend of the cross-process collectives, once chosen
_BACKEND: Optional[str] = None
#: the NCCL group over every process (None: the default gloo group)
_GROUP = None


def maybe_initialize_distributed(
    env: Optional[Mapping[str, str]] = None,
    autodetect: bool = False,
    devices: Optional[Sequence] = None,
) -> bool:
    """Join the process group when configured.

    Returns True when ``torch.distributed.init_process_group`` was called
    (so ``parallel.mesh.make_mesh`` spans every process's devices), False
    when running single-host. Safe to call more than once — a second call
    with the group already up is a no-op returning True. ``devices``: the
    devices this process's ranks run on, which choose the collectives'
    backend (default: every visible card, else the CPU)."""
    env = os.environ if env is None else env
    coord = env.get("SWARM_COORDINATOR", "")
    nproc = env.get("SWARM_NUM_PROCESSES", "")
    pid = env.get("SWARM_PROCESS_ID", "")

    if dist.is_available() and dist.is_initialized():
        return True  # already initialized

    configured = [bool(coord), bool(nproc), bool(pid)]
    if any(configured) and not all(configured):
        # a partial triplet silently running single-host would leave the
        # other hosts blocked at the coordinator barrier — fail loudly
        raise ValueError(
            "multi-host config incomplete: SWARM_COORDINATOR, "
            "SWARM_NUM_PROCESSES and SWARM_PROCESS_ID must all be set "
            f"(got coordinator={coord!r}, num_processes={nproc!r}, "
            f"process_id={pid!r})"
        )
    if coord:
        address, world, rank = coord, int(nproc), int(pid)
    elif autodetect and all(env.get(k) for k in TORCHRUN_ENV):
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{address}", world_size=world, rank=rank
    )
    _choose_backend(devices, world, rank)
    return True


def _device_ids(devices: Optional[Sequence]) -> list:
    """What identifies each of this process's devices across processes:
    ``("cpu",)`` for the CPU, a card's UUID for a CUDA device."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n)] or ["cpu"]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            out.append(("cpu",))
            continue
        index = d.index if d.index is not None else torch.cuda.current_device()
        uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
        out.append(("cuda", str(uuid) if uuid is not None
                    else f"{socket.gethostname()}:{index}"))
    return out


def _choose_backend(devices: Optional[Sequence], world: int, rank: int) -> str:
    """Exchange the processes' device ids over the gloo group and choose
    the collectives' backend (module doc); print and export it."""
    global _BACKEND, _GROUP
    mine = _device_ids(devices)
    every: list = [None] * world
    dist.all_gather_object(every, mine)
    cards = [{i[1] for i in ids if i[0] == "cuda"} for ids in every]
    if any(i[0] != "cuda" for ids in every for i in ids):
        backend, why = "gloo", "a process runs its ranks on the CPU"
    elif any(cards[a] & cards[b] for a in range(world) for b in range(a + 1, world)):
        backend, why = "gloo", ("processes share a card and NCCL refuses two ranks on one "
                                "GPU: collectives staged through host memory")
    else:
        backend, why = "nccl", "each process has its own cards"
        # no fallback: a group that fails to form raises
        _GROUP = dist.new_group(backend="nccl")
    _BACKEND = backend
    os.environ["SWARM_DIST_BACKEND"] = backend
    print(f"torch.distributed: process {rank} of {world}, collectives on {backend} ({why})",
          flush=True)
    return backend


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The group's size (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def collective_backend() -> str:
    """The backend of the cross-process collectives: ``gloo`` or
    ``nccl`` (gloo when the group was joined without the exchange)."""
    return _BACKEND or "gloo"


def world_group():
    """The group over every process on the collectives' backend (None:
    the default gloo group)."""
    return _GROUP


def new_group(ranks: Sequence[int]):
    """A group over ``ranks`` on the collectives' backend. Every process
    calls this, members or not, in the same order (``torch.distributed``'s
    rule for ``new_group``)."""
    ranks = sorted(ranks)
    if len(ranks) == process_count():
        return _GROUP
    return dist.new_group(ranks=ranks, backend=collective_backend())


def gather_objects(obj) -> list:
    """``obj`` of every process, in process order (one process: [obj])."""
    if process_count() == 1:
        return [obj]
    out: list = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out
