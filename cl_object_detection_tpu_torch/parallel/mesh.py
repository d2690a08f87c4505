"""The mesh's data axis on ``torch.distributed`` (the JAX package's
``parallel/mesh.py``, its ``data`` axis).

JAX shards one global batch over the devices of a ``Mesh`` and lets GSPMD
insert the reductions. The port runs one process per device instead, each
a rank of one process group, and reduces by hand:

  * ``init_distributed`` starts the group (a no-op for one process):
    from ``--coordinator_address/--num_processes/--process_id``
    (``tcp://``), from an explicit ``init_method`` (``file://``, the
    tests), or from ``torchrun``'s environment (the counterpart of a TPU
    pod's autodetection). Every rank then posts its host name to the
    group's store, so each knows the ranks on its own host whatever
    started them: its local rank is its place among them, and rank r
    takes ``cuda:(local_rank % cards)``.
  * The backend rule: NCCL when every rank of the host has a card of its
    own (ranks on the host <= ``torch.cuda.device_count()``); gloo on the
    CPU, and gloo when the process flags place several ranks on one card
    (NCCL refuses a duplicate GPU). gloo's collectives run here on host
    copies of the tensors. Under ``torchrun`` or ``cli.train --mesh``
    more ranks than cards raise.
  * ``create_mesh`` keeps JAX's check that ``num_data x num_model`` equals
    the devices (one per rank) and returns a ``DataMesh``. ``num_model >
    1`` and ZeRO-1 (``head_tp_spec``, ``zero1_extend_spec``,
    ``make_param_constraint``) raise: ROADMAP §1 item 6b.
  * Every rank computes the GLOBAL batch's loss: terms normalised over the
    whole batch take global counts (``all_reduce_sum``, no gradient) and
    are scaled by the world size, so that the mean over the ranks of
    their gradients, ``all_reduce_grads`` (one flat float32 buffer, the
    same bits on every rank), is the global batch's gradient, and every
    rank's Adam takes the same step. ``all_reduce_metrics`` gives the
    global loss terms.
  * The IL tool passes run whole on every rank, as JAX's multi-process
    rule has it (its ``tool_placers`` identity), and every rank keeps rank
    0's result (``broadcast_object``, ``broadcast_tensors``): cuDNN may
    pick other algorithms on two cards, and a value near a threshold would
    then part the ranks without an error. ``check_replicas`` compares a
    checksum of every parameter and buffer across the ranks.
  * Each rank's loader decodes its contiguous slice of the global batch
    (``data/loader.py``, ``proc_shard``), which is what
    ``global_batch_from_local`` stitches in JAX.

Collectives are called from the main thread only (never from the loader's
or the checkpoint writer's), in the same order on every rank. Every group
has a timeout (``DEFAULT_TIMEOUT``), so a rank that died ends the others'
next collective with an error instead of a hang.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import MeshConfig

DEFAULT_TIMEOUT = timedelta(seconds=120)
NOT_PORTED_6B = ("ZeRO-1 and the model axis (--zero1, --num_model > 1) are not ported yet: "
                 "ROADMAP §1 item 6b")


@dataclass(frozen=True)
class DataMesh:
    """This process's place on the data axis: its rank among ``world``
    ranks, its device, and the group's backend (None for one process)."""
    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.world, "model": 1}

    @property
    def comm_device(self) -> torch.device:
        """Where a collective's tensors live: the card under NCCL, the
        host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def active(mesh: Optional[DataMesh]) -> bool:
    """Whether ``mesh`` spans more than one rank (else every helper here
    is the identity)."""
    return mesh is not None and mesh.world > 1


def is_primary(mesh: Optional[DataMesh]) -> bool:
    return mesh is None or mesh.rank == 0


def backend_for(device: torch.device, ranks_per_host: int) -> str:
    """NCCL when each of the host's ranks has a card of its own, else gloo."""
    if device.type == "cuda" and ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def host_placement(rank: int, hosts: Sequence[str]) -> Tuple[int, int]:
    """(local rank, ranks on this host) of ``rank``, from every rank's
    host name in rank order."""
    mine = hosts[rank]
    return sum(h == mine for h in hosts[:rank]), sum(h == mine for h in hosts)


def _rendezvous(method: str, rank: int, world: int):
    """The group's store, and every rank's host name posted through it."""
    store, _, _ = next(dist.rendezvous(method, rank, world, timeout=DEFAULT_TIMEOUT))
    store.set_timeout(DEFAULT_TIMEOUT)
    store.set(f"mesh/host/{rank}", socket.gethostname())
    return store, [store.get(f"mesh/host/{r}").decode() for r in range(world)]


def free_port() -> int:
    """A TCP port on the loopback that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    cpu: bool = False,
    init_method: Optional[str] = None,
) -> torch.device:
    """Join the process group, if there is one, and return this rank's
    device (the CPU with ``cpu``). A no-op for one process: then the
    device is the one ``resolve_device`` gives. In a process that joined
    the group already it returns that rank's device (one process may run
    several entry points, ``cli.train`` then ``cli.validate``).

    The process flags (``coordinator_address`` as ``host:port``, or
    ``init_method``, with ``num_processes`` and ``process_id``) may place
    several ranks of a host on one card on purpose, over gloo. Without
    them ``torchrun``'s environment is read (``RANK``, ``WORLD_SIZE``),
    and a host with more ranks than cards raises. Either way the ranks on
    this host are counted from the host names every rank posts to the
    group's store (module docstring)."""
    from .. import resolve_device

    if dist.is_available() and dist.is_initialized():
        # a later entry point of a process that joined the group already
        if num_processes is not None and num_processes != dist.get_world_size():
            raise ValueError(f"--num_processes {num_processes} but the group has "
                             f"{dist.get_world_size()} ranks")
        return torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
    env = os.environ
    if coordinator_address is not None or init_method is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
        if num_processes <= 1:
            return resolve_device("cpu" if cpu else None)
        method = init_method or f"tcp://{coordinator_address}"
        rank, world, shared_ok = process_id, num_processes, True
    elif "RANK" in env and "WORLD_SIZE" in env and int(env["WORLD_SIZE"]) > 1:
        method = "env://"
        rank, world, shared_ok = int(env["RANK"]), int(env["WORLD_SIZE"]), False
    else:
        if num_processes is not None and num_processes > 1:
            raise ValueError("--num_processes > 1 needs --coordinator_address")
        return resolve_device("cpu" if cpu else None)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside 0..{world - 1}")
    if not cpu:
        resolve_device(None)                     # raises without CUDA
    store, hosts = _rendezvous(method, rank, world)
    local_rank, local_world = host_placement(rank, hosts)
    if cpu:
        device = torch.device("cpu")
        # the host's cores shared among its ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
    else:
        cards = torch.cuda.device_count()
        if local_world > cards and not shared_ok:
            raise RuntimeError(
                f"{local_world} ranks on this host but {cards} CUDA device(s): a rank "
                "would have no device of its own (start the ranks with the process "
                "flags to share a card on purpose, or pass --cpu)")
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device, local_world),
                            store=dist.PrefixStore("default_pg", store), world_size=world,
                            rank=rank, timeout=DEFAULT_TIMEOUT)
    return device


def create_mesh(cfg: Optional[MeshConfig] = None,
                device: Optional[torch.device] = None) -> DataMesh:
    """The data axis over the group's ranks, one device each (one rank
    when no group is initialized)."""
    cfg = cfg or MeshConfig()
    if cfg.zero1 or cfg.num_model > 1:
        raise NotImplementedError(NOT_PORTED_6B)
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    num_model = max(1, cfg.num_model)
    num_data = cfg.num_data if cfg.num_data > 0 else world // num_model
    if num_data * num_model != world:
        raise ValueError(f"mesh {num_data}x{num_model} != {world} devices")
    if device is None:
        from .. import resolve_device

        device = resolve_device(None)
    return DataMesh(rank=rank, world=world, device=torch.device(device),
                    backend=dist.get_backend() if up else None)


def describe(mesh: DataMesh) -> str:
    """The trainer's ``mesh:`` line."""
    route = {None: "one process",
             "nccl": "NCCL: one card per rank",
             "gloo": ("gloo on the CPU" if mesh.device.type == "cpu"
                      else "gloo: ranks share a card, collectives through the host")}
    return (f"mesh: {mesh.shape} over {mesh.world} devices "
            f"(rank {mesh.rank} on {mesh.device}; {route[mesh.backend]})")


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------

def barrier(mesh: Optional[DataMesh]) -> None:
    if not active(mesh):
        return
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


def broadcast_object(mesh: Optional[DataMesh], obj: Any) -> Any:
    """Rank 0's ``obj`` (picklable) on every rank."""
    if not active(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=mesh.comm_device)
    return box[0]


def all_gather_object(mesh: Optional[DataMesh], obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order, on every rank."""
    if not active(mesh):
        return [obj]
    out: List[Any] = [None] * mesh.world
    dist.all_gather_object(out, obj)
    return out


def _flat(tensors: Sequence[torch.Tensor], dtype, device) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors]).to(device)


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[at:at + n].view(t.shape).to(t.device, t.dtype))
        at += n
    return out


def broadcast_tensors(mesh: Optional[DataMesh], tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite ``tensors`` in place with rank 0's values: one flat
    buffer per dtype."""
    if not active(mesh) or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, group in by_dtype.items():
        flat = _flat(group, dtype, mesh.comm_device)
        dist.broadcast(flat, src=0)
        with torch.no_grad():
            for t, v in zip(group, _unflat(flat, group)):
                t.copy_(v)


def broadcast_module(mesh: Optional[DataMesh], module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers in ``module`` on every rank."""
    broadcast_tensors(mesh, list(module.parameters()) + list(module.buffers()))


def all_reduce_sum(mesh: Optional[DataMesh], x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, detached (the global count or
    sum of a batch-normalised loss term)."""
    if not active(mesh):
        return x
    buf = x.detach().to(mesh.comm_device, torch.float32, copy=True)
    dist.all_reduce(buf)
    return buf.to(x.device, x.dtype)


def all_reduce_grads(mesh: Optional[DataMesh],
                     grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of a gradient dict, through one flat
    float32 buffer: the summed buffer is the same on every rank, and so is
    its quotient by the world size."""
    if not active(mesh):
        return dict(grads)
    names, values = list(grads), list(grads.values())
    flat = _flat(values, torch.float32, mesh.comm_device)
    dist.all_reduce(flat)
    flat /= mesh.world
    return dict(zip(names, _unflat(flat, values)))


def all_reduce_metrics(mesh: Optional[DataMesh],
                       metrics: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of 0-d loss terms: each rank's term is its
    share of the global batch's, so the mean is the global value."""
    if not active(mesh) or not metrics:
        return dict(metrics)
    names, values = list(metrics), [v.detach() for v in metrics.values()]
    buf = torch.stack([v.float().to(mesh.comm_device) for v in values])
    dist.all_reduce(buf)
    buf /= mesh.world
    return {k: buf[i].to(v.device) for i, (k, v) in enumerate(zip(names, values))}


def batch_global(mesh: Optional[DataMesh], value: torch.Tensor) -> torch.Tensor:
    """A loss term whose value is already the global batch's on every
    rank (computed from globally reduced statistics) but whose gradient
    reaches only through this rank's share: the value stays, the
    gradient is scaled by the world size, so the mean over the ranks of
    the gradients is the global one."""
    if not active(mesh):
        return value
    return value + (mesh.world - 1) * (value - value.detach())


# ----------------------------------------------------------------------
# replicas
# ----------------------------------------------------------------------

_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def module_checksums(module: torch.nn.Module) -> Dict[str, int]:
    """An exact checksum of every parameter and buffer: the sum, in
    int64, of its elements' bit patterns."""
    named = list(module.named_parameters()) + list(module.named_buffers())
    sums = torch.stack([
        t.detach().contiguous().view(_INT_OF_SIZE[t.element_size()]).sum(dtype=torch.int64)
        for _, t in named])
    return dict(zip([n for n, _ in named], sums.cpu().tolist()))


def check_replicas(mesh: Optional[DataMesh], module: torch.nn.Module,
                   what: str = "model") -> Dict[str, int]:
    """Raise unless every rank holds bit-identical parameters and buffers
    (checksums compared across the ranks); returns this rank's
    checksums."""
    sums = module_checksums(module)
    if not active(mesh):
        return sums
    rows = all_gather_object(mesh, sums)
    bad = sorted({k for r in rows[1:] for k in set(r) | set(rows[0])
                  if r.get(k) != rows[0].get(k)})
    if bad:
        raise RuntimeError(f"the ranks' {what} parted: {len(bad)} tensors differ from rank "
                           f"0's, e.g. {bad[:3]}")
    return sums


# ----------------------------------------------------------------------
# batches
# ----------------------------------------------------------------------

def proc_shard(mesh: Optional[DataMesh]) -> Dict[str, int]:
    """``BatchLoader`` kwargs of this rank's slice of every global batch
    (none for one rank)."""
    if not active(mesh):
        return {}
    return {"process_index": mesh.rank, "process_count": mesh.world}


# ----------------------------------------------------------------------
# launching
# ----------------------------------------------------------------------

def spawn_ranks(fn: Callable, nprocs: int, args: tuple = ()) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes and wait for
    them; the first that raises ends the others, and the error is raised
    here."""
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=args, nprocs=nprocs, join=True, start_method="spawn")
