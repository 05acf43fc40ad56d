"""Ranks and their process groups (counterpart of ``pmpu_tpu/parallel/mesh.py``).

The JAX package expresses scaling as a ``jax.sharding.Mesh`` over devices
with a ``data`` and a ``model`` axis, and XLA inserts the collectives. The
port runs one process a card (a rank) under ``torch.distributed``: NCCL
between cards, gloo between CPU processes (the tests). A :class:`Mesh` here
is the ranks of the default process group laid out as ``data × model``:
rank r sits at data index ``r // model`` and model index ``r % model``, as
JAX's ``reshape(data, model)`` of the device list (:29) places device r.
With ``model > 1`` the mesh holds two process groups of this rank, made
once by :func:`make_mesh`: its data column (the ranks of its model index,
over which batches are split and gradients summed) and its model row (the
ranks of its data index, over which channels are sharded,
``parallel/tensor.py``). With ``model == 1`` the data column is the
default process group.

* :func:`init_distributed` — the counterpart of ``multihost_init`` (:42):
  joins the world that ``torchrun`` (or :func:`spawn_world`) describes in
  the environment, a no-op returning ``(0, 1)`` without one.
* :func:`data_sharding` — a data index's block of a batch's rows, split as
  ``torch.tensor_split`` splits them (the first ``n % data`` blocks one row
  longer; a block may be empty).
* :func:`replicated` — rank 0's values of a module's parameters and
  buffers on every rank (one broadcast of one flat buffer).
* :func:`next_world_env` — what a re-exec of every rank (the train CLI's
  ``--rss-limit-mb``) sets in the environment so that the new processes
  meet in a fresh rendezvous: a world generation, under whose prefix
  :func:`init_distributed` keeps the new world's store keys (torchrun's
  agent store outlives the re-exec, and the first world's keys are still in
  it), and, where rank 0 hosts the store itself (:func:`spawn_world`, a
  hand-set environment), a new ``MASTER_PORT``: the old store dies with
  rank 0's old process image.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from pmpu_tpu_torch.device import resolve_device

# what torchrun sets in each worker's environment
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# the generation of a world that re-executed its ranks (``next_world_env``)
GENERATION = "PMPU_WORLD_GENERATION"


def world() -> tuple:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device(device=None) -> torch.device:
    """``device`` resolved (None: ``"cuda"``); a CUDA device becomes
    ``cuda:{LOCAL_RANK}`` when the environment names a local rank."""
    dev = resolve_device(device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = resolve_device(f"cuda:{int(os.environ['LOCAL_RANK'])}")
    return dev


def init_distributed(device=None) -> tuple:
    """Join the world described by torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return ``(rank, world size)``: NCCL for a CUDA device, with this process
    bound to ``cuda:{LOCAL_RANK}``, gloo for the CPU. Without
    ``WORLD_SIZE`` in the environment it does nothing and returns ``(0,
    1)``. A failure to join raises; nothing carries on alone. The store's
    keys go under the prefix of the world's generation
    (``PMPU_WORLD_GENERATION``, 0 for a first start; :func:`next_world_env`)."""
    if "WORLD_SIZE" not in os.environ:
        return 0, 1
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: WORLD_SIZE is set but {missing} are not")
    dev = local_device(device)
    if dist.is_initialized():
        return world()
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    url = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    backend = "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "nccl"
    store, _, _ = next(dist.rendezvous(f"{url}?rank={rank}&world_size={size}"))
    store = dist.PrefixStore(f"pmpu_world_generation_{os.environ.get(GENERATION, '0')}/", store)
    dist.init_process_group(backend, store=store, rank=rank, world_size=size)
    return rank, size


def next_world_env() -> dict:
    """The environment variables under which a re-exec of every rank of
    this world joins a fresh world: the next generation, and a new
    ``MASTER_PORT`` (a free port of rank 0's, broadcast) unless torchrun's
    agent hosts the store. A collective: every rank calls it, before the
    process group is destroyed."""
    env = {GENERATION: str(int(os.environ.get(GENERATION, "0")) + 1)}
    if os.environ.get("TORCHELASTIC_USE_AGENT_STORE") != "True":
        cuda = dist.get_backend() == "nccl"
        dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
        port = torch.tensor([free_port() if world()[0] == 0 else 0], device=dev)
        dist.broadcast(port, 0)
        env["MASTER_PORT"] = str(int(port.item()))
    return env


def free_port() -> int:
    """A TCP port on localhost that no socket holds at the moment of asking."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(local_rank, nprocs, port, fn, args):
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    fn(*args)


def spawn_world(fn, nprocs: int, args=()) -> None:
    """Run ``fn(*args)`` in ``nprocs`` fresh processes (the ``spawn`` start
    method) that form one world on this host: each finds torchrun's
    variables in its environment (rank = local rank, a free port), so
    ``fn`` joins with :func:`init_distributed`. ``fn`` must be importable
    (a module-level function). Returns when every process has ended; a
    process that raises or dies makes it raise, and the others are ended."""
    import torch.multiprocessing as mp

    mp.start_processes(_spawned, args=(nprocs, free_port(), fn, tuple(args)), nprocs=nprocs,
                       join=True, start_method="spawn")


@dataclass(frozen=True)
class _Groups:
    """This rank's process groups on a ``data × model`` mesh."""

    data: object  # its data column: the ranks of its model index
    model: object  # its model row: the ranks of its data index


@dataclass(frozen=True)
class Mesh:
    """``data × model`` ranks of the default process group; ``groups`` are
    this rank's (None with ``model == 1``)."""

    data: int
    model: int = 1
    groups: _Groups | None = field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return world()[0] // self.model

    @property
    def model_index(self) -> int:
        return world()[0] % self.model

    @property
    def data_group(self):
        """The process group over the data axis (None: the default group)."""
        return None if self.groups is None else self.groups.data

    @property
    def model_group(self):
        return None if self.groups is None else self.groups.model

    def __deepcopy__(self, memo):
        return self  # immutable; its process groups are not copied


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh of the world's ranks; ``data=-1`` takes all
    the ranks ``model`` leaves (JAX :17, the same checks). With ``model >
    1`` every rank makes the ``model`` data columns, then the ``data`` model
    rows, in that order (``dist.new_group`` is a collective of the whole
    world), and keeps its own: every rank must call it alike."""
    n = world()[1]
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} ranks")
    if model == 1:
        return Mesh(data)
    rank = world()[0]
    columns = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    rows = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    groups = _Groups(columns[rank % model], rows[rank // model]) if rank < data * model else None
    return Mesh(data, model, groups)


def data_sharding(mesh: Mesh, n: int, index: int | None = None) -> slice:
    """The rows of a batch of ``n`` that data index ``index`` (default: this
    rank's, ``mesh.data_index``) holds, as ``torch.tensor_split(rows,
    mesh.data)`` gives them: the first ``n % data`` indices one row more.
    Every model index of a data index holds the same rows."""
    r = mesh.data_index if index is None else index
    base, extra = divmod(n, mesh.data)
    start = r * base + min(r, extra)
    return slice(start, start + base + (r < extra))


def replicated(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Give every rank rank ``src``'s parameters and buffers (one broadcast
    of one flat buffer a dtype); nothing without a process group."""
    if world()[1] == 1:
        return module
    tensors = [t for t in (*module.parameters(), *module.buffers())]
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src)
        with torch.no_grad():
            for t, v in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(v.view_as(t))
    return module
