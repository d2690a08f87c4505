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
    1`` (``head_tp_spec``, ``make_param_constraint`` on the model axis)
    raises: ROADMAP §1 item 6b.
  * Every rank computes the GLOBAL batch's loss: terms normalised over the
    whole batch take global counts (``all_reduce_sum``, no gradient) and
    are scaled by the world size, so that the mean over the ranks of
    their gradients, ``all_reduce_grads`` (one flat float32 buffer, the
    same bits on every rank), is the global batch's gradient, and every
    rank's Adam takes the same step. ``all_reduce_metrics`` gives the
    global loss terms.
  * ZeRO-1 (``MeshConfig.zero1``, JAX's ``zero1_extend_spec`` and
    ``make_param_constraint``): each rank keeps the Adam moments of its
    slice of every leaf that ``zero1_shard`` splits (JAX's rule, mapped
    through the bridge's HWIO -> OIHW order so that the port splits the
    same axis of the same leaf), takes the Adam step on its slices of the
    whole, all-reduced gradient, and ``param_all_gather`` reassembles the
    parameters from every rank's slices (one flat buffer per dtype).
  * The IL tool passes split their loader's whole batches over the ranks,
    round robin (``pass_loader``: batch i on rank i mod W, each forward at
    one process's batch size), and gather the per-batch or per-image
    results back into the loader's order (``gather_batches``,
    ``gather_to_primary``), so every rank reduces the same bits in one
    process's order. ``check_replicas`` compares a checksum of every
    parameter and buffer across the ranks.
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
NOT_PORTED_6B = "the model axis (--num_model > 1) is not ported yet: ROADMAP §1 item 6b"


@dataclass(frozen=True)
class DataMesh:
    """This process's place on the data axis: its rank among ``world``
    ranks, its device, the group's backend (None for one process), and
    whether ZeRO-1 shards the Adam moments (only with several ranks)."""
    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    zero1: bool = False

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
    if cfg.num_model > 1:
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
    # ZeRO-1 on one rank is a no-op, as zero1_extend_spec is for ndata <= 1
    return DataMesh(rank=rank, world=world, device=torch.device(device),
                    backend=dist.get_backend() if up else None,
                    zero1=bool(cfg.zero1) and world > 1)


def describe(mesh: DataMesh, moment_bytes: Optional[int] = None) -> str:
    """The trainer's ``mesh:`` line; under ZeRO-1 with ``moment_bytes``
    (the Adam moments this rank keeps)."""
    route = {None: "one process",
             "nccl": "NCCL: one card per rank",
             "gloo": ("gloo on the CPU" if mesh.device.type == "cpu"
                      else "gloo: ranks share a card, collectives through the host")}
    zero1 = ""
    if mesh.zero1:
        zero1 = "; ZeRO-1 on" + (f", {moment_bytes} bytes of Adam moments on this rank"
                                 if moment_bytes is not None else "")
    return (f"mesh: {mesh.shape} over {mesh.world} devices "
            f"(rank {mesh.rank} on {mesh.device}; {route[mesh.backend]}{zero1})")


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


def all_reduce_sums(mesh: Optional[DataMesh], tensors: Mapping[str, torch.Tensor],
                    mean: bool = False) -> Dict[str, torch.Tensor]:
    """The sum (with ``mean``, the mean) over the ranks of a dict of
    tensors, through one flat float32 buffer: the summed buffer is the
    same on every rank, and so is its quotient by the world size."""
    if not active(mesh):
        return dict(tensors)
    names, values = list(tensors), list(tensors.values())
    flat = _flat(values, torch.float32, mesh.comm_device)
    dist.all_reduce(flat)
    if mean:
        flat /= mesh.world
    return dict(zip(names, _unflat(flat, values)))


def all_reduce_grads(mesh: Optional[DataMesh],
                     grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of a gradient dict (``all_reduce_sums``)."""
    return all_reduce_sums(mesh, grads, mean=True)


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
# ZeRO-1
# ----------------------------------------------------------------------

Shard = Tuple[int, slice]

# the dims of a port conv weight (O, I, kh, kw) in JAX's HWIO order
# (kh, kw, I, O): JAX's dim j is the port's dim _OIHW_OF_HWIO[j]
_OIHW_OF_HWIO = (2, 3, 1, 0)


def zero1_shard(shape: Sequence[int], ndata: int, rank: int) -> Optional[Shard]:
    """JAX's ``zero1_extend_spec`` on a port parameter's shape: the
    largest dim that ``ndata`` divides (at least ``ndata`` long), the first
    of equal sizes in JAX's dim order (a 4-D weight read as HWIO), as the
    port's dim, with this rank's slice of it; None when no dim divides or
    ``ndata <= 1`` (the leaf stays whole on every rank)."""
    shape = tuple(int(n) for n in shape)
    if ndata <= 1 or not shape:
        return None
    order = _OIHW_OF_HWIO if len(shape) == 4 else range(len(shape))
    best = None
    for d in order:
        n = shape[d]
        if n >= ndata and n % ndata == 0 and (best is None or n > shape[best]):
            best = d
    if best is None:
        return None
    size = shape[best] // ndata
    return best, slice(rank * size, (rank + 1) * size)


def zero1_plan(mesh: Optional[DataMesh],
               named_params) -> Dict[str, Optional[Shard]]:
    """``zero1_shard`` of every ``(name, parameter)`` for this rank; all
    None unless ZeRO-1 is on over several ranks."""
    on = active(mesh) and mesh.zero1
    return {n: zero1_shard(p.shape, mesh.world, mesh.rank) if on else None
            for n, p in named_params}


def shard_of(t: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """This rank's slice of ``t`` (a view; ``t`` itself when whole)."""
    if shard is None:
        return t
    dim, sl = shard
    return t.narrow(dim, sl.start, sl.stop - sl.start)


def _all_gather_flat(mesh: DataMesh, out: torch.Tensor, mine: torch.Tensor) -> None:
    """Every rank's ``mine`` into ``out``, in rank order: NCCL's single-buffer
    all-gather, gloo's all-gather into the ranks' views of ``out``."""
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, mine)
    else:
        dist.all_gather(list(out.view(mesh.world, -1).unbind(0)), mine)


def gather_shards(mesh: DataMesh,
                  pieces: Sequence[Tuple[torch.Tensor, Sequence[int], Shard]]) -> List[torch.Tensor]:
    """The whole tensors of ``pieces``, each ``(this rank's slice, the
    whole shape, its shard)``, reassembled from every rank's slices on the
    slices' device: one all-gather of one flat buffer per dtype (every
    rank's slices are the same sizes)."""
    out: List[Optional[torch.Tensor]] = [None] * len(pieces)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, (t, _, _) in enumerate(pieces):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        mine = torch.cat([pieces[i][0].detach().reshape(-1) for i in idx]).to(mesh.comm_device)
        flat = mine.new_empty(mesh.world * mine.numel())
        _all_gather_flat(mesh, flat, mine)
        ranks = flat.to(pieces[idx[0]][0].device).view(mesh.world, -1)
        at = 0
        for i in idx:
            t, shape, (dim, _) = pieces[i]
            n = t.numel()
            part = ranks[:, at:at + n].reshape((mesh.world,) + tuple(t.shape))
            out[i] = torch.cat(part.unbind(0), dim=dim).reshape(tuple(shape))
            at += n
    return out


def param_all_gather(mesh: Optional[DataMesh], params: Mapping[str, torch.Tensor],
                     plan: Mapping[str, Optional[Shard]]) -> None:
    """ZeRO-1's all-gather: overwrite every sharded parameter of ``params``
    in place with the ranks' slices of it (this rank's updated slice
    included), one flat buffer per dtype: NCCL's all-gather on the card,
    gloo's through host copies. Whole leaves are left as they are."""
    if not active(mesh):
        return
    names = [n for n in params if plan.get(n) is not None]
    if not names:
        return
    pieces = [(shard_of(params[n], plan[n]), params[n].shape, plan[n]) for n in names]
    with torch.no_grad():
        for n, whole in zip(names, gather_shards(mesh, pieces)):
            params[n].copy_(whole)


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


# ----------------------------------------------------------------------
# the IL tool passes
# ----------------------------------------------------------------------

def pass_loader(mesh: Optional[DataMesh], loader):
    """This rank's share of a tool pass's loader: whole batches, round
    robin (batch i on rank i mod W), each at the batch size one process
    runs. A ``BatchLoader`` decodes only this rank's batches
    (``round_robin``); any other iterable of batches is read in full and
    every W-th kept. The loader itself on one rank."""
    if not active(mesh):
        return loader
    if hasattr(loader, "round_robin"):
        return loader.round_robin(mesh.rank, mesh.world)
    import itertools

    return itertools.islice(loader, mesh.rank, None, mesh.world)


def gather_batches(mesh: Optional[DataMesh], items: Sequence[Any]) -> List[Any]:
    """Every rank's per-batch results of a ``pass_loader`` pass (this
    rank's in its batch order, picklable), merged into the loader's batch
    order, on every rank: batch i is rank (i mod W)'s (i div W)-th. The
    ranks may hold counts that differ by one (trailing batches)."""
    if not active(mesh):
        return list(items)
    rows = all_gather_object(mesh, list(items))
    return [rows[i % mesh.world][i // mesh.world] for i in range(sum(map(len, rows)))]


def gather_to_primary(mesh: Optional[DataMesh], tensor: torch.Tensor,
                      obj: Any = None) -> Optional[List[Tuple[Any, torch.Tensor]]]:
    """Every rank's ``(obj, tensor)`` (tensors of one shape and dtype) on
    rank 0, in rank order, on the host; None on the other ranks. Only rank
    0 receives (``dist.gather``), so only rank 0 holds W tensors. One
    rank's own pair on one rank."""
    if not active(mesh):
        return [(obj, tensor.detach().cpu())]
    t = tensor.detach().to(mesh.comm_device).contiguous()
    primary = mesh.rank == 0
    tensors = [torch.empty_like(t) for _ in range(mesh.world)] if primary else None
    dist.gather(t, tensors, dst=0)
    objs: Optional[List[Any]] = [None] * mesh.world if primary else None
    dist.gather_object(obj, objs, dst=0)
    if not primary:
        return None
    return [(o, x.cpu()) for o, x in zip(objs, tensors)]


def broadcast_arrays(mesh: Optional[DataMesh],
                     arrays: Optional[Mapping[Any, Any]]) -> Dict[Any, Any]:
    """Rank 0's ``{key: float32 numpy array}`` on every rank (herding's
    class means): the keys and shapes as an object, the values as one
    flat float32 buffer, bit for bit. Other ranks pass None."""
    import numpy as np

    if not active(mesh):
        return dict(arrays)
    meta = broadcast_object(mesh, None if arrays is None else
                            [(k, tuple(np.shape(v))) for k, v in arrays.items()])
    total = sum(int(np.prod(shape)) for _, shape in meta)
    if mesh.rank == 0:
        flat = torch.from_numpy(np.concatenate(
            [np.asarray(arrays[k], np.float32).reshape(-1) for k, _ in meta]
            or [np.zeros(0, np.float32)])).to(mesh.comm_device)
    else:
        flat = torch.empty(total, dtype=torch.float32, device=mesh.comm_device)
    dist.broadcast(flat, src=0)
    flat = flat.cpu().numpy()
    out, at = {}, 0
    for k, shape in meta:
        n = int(np.prod(shape))
        out[k] = flat[at:at + n].reshape(shape).copy()
        at += n
    return out
