"""The mesh's two axes on ``torch.distributed`` (the JAX package's
``parallel/mesh.py``): ``data`` and ``model``.

JAX shards one global batch over the devices of a ``Mesh`` and lets GSPMD
insert the reductions. The port runs one process per device instead, each
a rank of one process group, and reduces by hand:

  * ``init_distributed`` starts the group (a no-op for one process):
    from ``--coordinator_address/--num_processes/--process_id``
    (``tcp://``, or a ``file://`` URL), from an explicit ``init_method``
    (``file://``, the tests), or from ``torchrun``'s environment (the
    counterpart of a TPU pod's autodetection). Every rank then posts its
    host name to the group's store, so each knows the ranks on its own
    host whatever started them: its local rank is its place among them,
    and rank r takes ``cuda:(local_rank % cards)``.
  * The backend rule: NCCL when every rank of the host has a card of its
    own (ranks on the host <= ``torch.cuda.device_count()``); gloo on the
    CPU, and gloo when the process flags place several ranks on one card
    (NCCL refuses a duplicate GPU). gloo's collectives run here on host
    copies of the tensors. Under ``torchrun`` or ``cli.train --mesh``
    more ranks than cards raise.
  * ``create_mesh`` keeps JAX's check that ``num_data x num_model`` equals
    the devices (one per rank) and returns a ``DataMesh``: the ranks form
    a ``num_data x num_model`` grid in JAX's row-major order (rank r has
    data index ``r // num_model`` and model index ``r % num_model``). The
    ranks of one model index form a *data group*, those of one data index
    a *model group*; every rank creates every group, in the same order.
  * The data axis. Every rank computes its data index's share of the
    GLOBAL batch's loss: terms normalised over the whole batch take global
    counts (``all_reduce_sum`` over the data group, no gradient) and are
    scaled by ``num_data``, so that the mean of the gradients,
    ``all_reduce_grads`` (one flat float32 buffer, the same bits on every
    rank), is the global batch's gradient, and every rank's Adam takes the
    same step. ``all_reduce_metrics`` gives the global loss terms. The
    ranks of a model group read the same slice of every batch
    (``proc_shard``) and hold the same whole gradient up to the card's
    nondeterministic reductions, so both means run over every rank: the
    data group's mean, the same bits everywhere.
  * The model axis (JAX's ``head_tp_spec``): the head trunks' 3x3 convs
    split over the model group, Megatron-style. ``conv1``/``conv3`` are
    column-parallel (the rank's slice of the output channels and of the
    bias; ``copy_to_model``, Megatron's *f*: identity forward, all-reduce
    of the input's gradient in backward); every other ``convN`` is
    row-parallel (the rank's slice of the input channels;
    ``reduce_from_model``, Megatron's *g*: the partial outputs all-reduced
    forward, identity backward; the whole bias added once, after it).
    Every rank keeps WHOLE parameters: only the student's forward in the
    train step (and A-GEM's replay gradient, the same loss) reads the
    rank's slices, as views (``models/heads.py``, ``head_parallel``);
    after backward ``gather_model_grads`` all-gathers the slices'
    gradients over the model group into the whole gradient, and the data
    axis's code runs on it as it stands. ``head_tp_shard`` is the rule,
    on the port's OIHW leaves.
  * Adam's moments (JAX's ``shard_train_state``, ``zero1_extend_spec`` and
    ``make_param_constraint``): each rank keeps the moments of its block of
    every leaf, ``leaf_shard``: ``head_tp_shard``'s slice on the model
    axis, then, under ZeRO-1 (``MeshConfig.zero1``), ``zero1_shard``'s
    slice of a free dim on the data axis (JAX's rule, mapped through the
    bridge's HWIO -> OIHW order so that the port splits the same axis of
    the same leaf). It takes the Adam step on its block of the whole,
    reduced gradient, and ``param_all_gather`` reassembles the parameters
    from the ranks' blocks (one flat buffer per dtype).
  * The IL tool passes split their loader's whole batches over ALL the
    ranks, round robin (``pass_loader``: batch i on rank i mod W, each
    forward at one process's batch size, on whole weights), and gather the
    per-batch or per-image results back into the loader's order
    (``gather_batches``, ``gather_to_primary``), so every rank reduces the
    same bits in one process's order. ``check_replicas`` compares a
    checksum of every parameter and buffer across all the ranks.

Collectives are called from the main thread only (never from the loader's
or the checkpoint writer's), in the same order on every rank. Every group
has a timeout (``DEFAULT_TIMEOUT``), so a rank that died ends the others'
next collective with an error instead of a hang. Each collective that runs
is a span ``cldet.mesh.<name>`` whose bytes are its buffer's
(``utils/profiling.py``): its counters give the calls and bytes, a
profiled stretch its stream time.
"""
from __future__ import annotations

import math
import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..utils.profiling import span

DEFAULT_TIMEOUT = timedelta(seconds=120)


@dataclass(frozen=True)
class DataMesh:
    """This process's place on the ``num_data x num_model`` mesh: its rank
    among ``world`` ranks, its device, the group's backend (None for one
    process), whether ZeRO-1 shards the Adam moments (only with several
    ranks on the data axis), the model axis's size, and this rank's data
    group (the ranks of its model index; None: every rank, when
    ``num_model`` is 1) and model group (the ranks of its data index)."""
    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    zero1: bool = False
    num_model: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def num_data(self) -> int:
        return self.world // self.num_model

    @property
    def data_index(self) -> int:
        return self.rank // self.num_model

    @property
    def model_index(self) -> int:
        return self.rank % self.num_model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.num_data, "model": self.num_model}

    @property
    def comm_device(self) -> torch.device:
        """Where a collective's tensors live: the card under NCCL, the
        host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def active(mesh: Optional[DataMesh]) -> bool:
    """Whether ``mesh`` spans more than one rank (else every world-wide
    helper here is the identity)."""
    return mesh is not None and mesh.world > 1


def data_active(mesh: Optional[DataMesh]) -> bool:
    """Whether the data axis has several ranks (else every data-group
    helper here is the identity)."""
    return mesh is not None and mesh.num_data > 1


def model_active(mesh: Optional[DataMesh]) -> bool:
    """Whether the model axis has several ranks (the head trunks split)."""
    return mesh is not None and mesh.num_model > 1


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
        method = init_method or (coordinator_address if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
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
        # the host's threads shared among its ranks: OMP_NUM_THREADS when set
        # (``cli.common.start_ranks`` sets it to its own count), else the cores
        budget = int(os.environ.get("OMP_NUM_THREADS") or os.cpu_count() or 1)
        torch.set_num_threads(max(1, budget // local_world))
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
    """The ``num_data x num_model`` mesh over the group's ranks, one device
    each (one rank when no group is initialized), with its data and model
    groups: every rank creates every group, in the same order."""
    cfg = cfg or MeshConfig()
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
    data_group = model_group = None
    if num_model > 1:
        for m in range(num_model):
            g = dist.new_group([d * num_model + m for d in range(num_data)],
                               timeout=DEFAULT_TIMEOUT)
            if rank % num_model == m:
                data_group = g
        for d in range(num_data):
            g = dist.new_group([d * num_model + m for m in range(num_model)],
                               timeout=DEFAULT_TIMEOUT)
            if rank // num_model == d:
                model_group = g
    # ZeRO-1 without a data axis is a no-op, as zero1_extend_spec is for ndata <= 1
    return DataMesh(rank=rank, world=world, device=torch.device(device),
                    backend=dist.get_backend() if up else None,
                    zero1=bool(cfg.zero1) and num_data > 1, num_model=num_model,
                    data_group=data_group, model_group=model_group)


def describe(mesh: DataMesh, moment_bytes: Optional[int] = None) -> str:
    """The trainer's ``mesh:`` line: both axes, this rank's place on them,
    the route of its collectives, and, with ``moment_bytes``, the Adam
    moments this rank keeps."""
    route = {None: "one process",
             "nccl": "NCCL: one card per rank",
             "gloo": ("gloo on the CPU" if mesh.device.type == "cpu"
                      else "gloo: ranks share a card, collectives through the host")}
    axes = ""
    if mesh.num_model > 1:
        axes = f"; data index {mesh.data_index}, model index {mesh.model_index}"
    zero1 = "; ZeRO-1 on" if mesh.zero1 else ""
    moments = (f"; {moment_bytes} bytes of Adam moments on this rank"
               if moment_bytes is not None and (mesh.zero1 or mesh.num_model > 1) else "")
    return (f"mesh: {mesh.shape} over {mesh.world} devices "
            f"(rank {mesh.rank} on {mesh.device}; {route[mesh.backend]}{axes}{zero1}{moments})")


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


def _axis(mesh: DataMesh, axis: str) -> Tuple[Any, int]:
    """(process group, ranks) of this rank's ``axis``: ``"data"`` (its data
    group), ``"model"`` (its model group) or ``"world"`` (every rank)."""
    if axis == "data":
        return mesh.data_group, mesh.num_data
    if axis == "model":
        return mesh.model_group, mesh.num_model
    return None, mesh.world


def _spans(mesh: Optional[DataMesh], axis: str) -> bool:
    return mesh is not None and _axis(mesh, axis)[1] > 1


def all_reduce_sum(mesh: Optional[DataMesh], x: torch.Tensor,
                   axis: str = "data") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (default: the data
    group), detached (the global count or sum of a batch-normalised loss
    term; ``axis="world"`` for a tool pass split over every rank)."""
    if not _spans(mesh, axis):
        return x
    with span("cldet.mesh.all_reduce_sum", 4 * x.numel()):
        buf = x.detach().to(mesh.comm_device, torch.float32, copy=True)
        dist.all_reduce(buf, group=_axis(mesh, axis)[0])
        return buf.to(x.device, x.dtype)


def all_reduce_sums(mesh: Optional[DataMesh], tensors: Mapping[str, torch.Tensor],
                    mean: bool = False, axis: str = "data") -> Dict[str, torch.Tensor]:
    """The sum (with ``mean``, the mean) over the ranks of ``axis``
    (default: the data group) of a dict of tensors, through one flat
    float32 buffer: the summed buffer is the same on every rank, and so is
    its quotient by the axis's size."""
    if not _spans(mesh, axis):
        return dict(tensors)
    group, size = _axis(mesh, axis)
    names, values = list(tensors), list(tensors.values())
    with span("cldet.mesh.all_reduce_sums", 4 * sum(v.numel() for v in values)):
        flat = _flat(values, torch.float32, mesh.comm_device)
        dist.all_reduce(flat, group=group)
        if mean:
            flat /= size
        return dict(zip(names, _unflat(flat, values)))


def all_reduce_grads(mesh: Optional[DataMesh],
                     grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over every rank of a gradient dict (``all_reduce_sums``):
    the ranks of a model group hold the same whole gradient up to the
    card's nondeterministic reductions (a replicated leaf's gradient is
    computed on each of them), so this is the data group's mean, and it
    leaves every rank the same bits. On the data axis alone the world is
    the data group."""
    return all_reduce_sums(mesh, grads, mean=True, axis="world")


def all_reduce_metrics(mesh: Optional[DataMesh],
                       metrics: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over every rank of 0-d loss terms: each rank's term is its
    data index's share of the global batch's (the same on the ranks of a
    model group, up to the card's reductions), so the mean is the global
    value, the same bits on every rank (a decision taken on it, such as
    the final correction's skip, is the same everywhere)."""
    if not active(mesh) or not metrics:
        return dict(metrics)
    names, values = list(metrics), [v.detach() for v in metrics.values()]
    with span("cldet.mesh.all_reduce_metrics", 4 * len(values)):
        buf = torch.stack([v.float().to(mesh.comm_device) for v in values])
        dist.all_reduce(buf)
        buf /= mesh.world
        return {k: buf[i].to(v.device) for i, (k, v) in enumerate(zip(names, values))}


def batch_global(mesh: Optional[DataMesh], value: torch.Tensor) -> torch.Tensor:
    """A loss term whose value is already the global batch's on every
    rank (computed from globally reduced statistics) but whose gradient
    reaches only through this rank's share: the value stays, the
    gradient is scaled by the data axis's size, so the mean over the data
    group of the gradients is the global one."""
    if not data_active(mesh):
        return value
    return value + (mesh.num_data - 1) * (value - value.detach())


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
# the blocks of a leaf: the model axis, then ZeRO-1
# ----------------------------------------------------------------------

Split = Tuple[int, slice]          # one dim of a leaf and this rank's slice of it
Shard = Tuple[Split, ...]          # this rank's block: one split per axis that splits it

# the dims of a port conv weight (O, I, kh, kw) in JAX's HWIO order
# (kh, kw, I, O): JAX's dim j is the port's dim _OIHW_OF_HWIO[j]
_OIHW_OF_HWIO = (2, 3, 1, 0)
_HEADS = ("regression_head", "classification_head")


def head_tp_kind(name: str) -> Optional[str]:
    """``"column"`` or ``"row"`` for a head-trunk conv's parameter (JAX's
    ``head_tp_spec`` rule on a dotted name: a ``convN`` component, N one
    digit, under a head; ``conv1``/``conv3`` column-parallel, every other
    ``convN`` row-parallel), else None (replicated)."""
    parts = name.split(".")
    if not any(p in _HEADS for p in parts):
        return None
    conv = next((p for p in parts if p.startswith("conv") and len(p) == 5), None)
    if conv is None:
        return None
    return "column" if conv in ("conv1", "conv3") else "row"


def head_tp_shard(name: str, shape: Sequence[int], num_model: int,
                  index: int) -> Optional[Split]:
    """JAX's ``head_tp_spec`` on a port parameter: the model axis's split
    of a head-trunk conv, in OIHW, and model index ``index``'s slice of it.
    A column-parallel weight splits its output channels (dim 0) and its
    bias; a row-parallel weight its input channels (dim 1), its bias stays
    whole. None for a replicated leaf or ``num_model <= 1``. Raises when
    the channels do not divide (GSPMD would pad them)."""
    kind = head_tp_kind(name)
    if num_model <= 1 or kind is None:
        return None
    if len(shape) == 4:
        dim = 0 if kind == "column" else 1
    elif len(shape) == 1 and kind == "column":
        dim = 0
    else:
        return None
    n = int(shape[dim])
    if n % num_model:
        raise ValueError(f"{name}: {n} channels do not divide over the model axis's "
                         f"{num_model} ranks (fpn_channels must divide by --num_model)")
    size = n // num_model
    return dim, slice(index * size, (index + 1) * size)


def zero1_shard(shape: Sequence[int], ndata: int, rank: int,
                base: Optional[Split] = None) -> Optional[Split]:
    """JAX's ``zero1_extend_spec`` on a port parameter's shape: the
    largest dim that ``ndata`` divides (at least ``ndata`` long) among the
    dims ``base`` (the model axis's split, or None) leaves free, the first
    of equal sizes in JAX's dim order (a 4-D weight read as HWIO), as the
    port's dim, with data index ``rank``'s slice of it; None when no dim
    divides or ``ndata <= 1``."""
    shape = tuple(int(n) for n in shape)
    if ndata <= 1 or not shape:
        return None
    order = _OIHW_OF_HWIO if len(shape) == 4 else range(len(shape))
    best = None
    for d in order:
        n = shape[d]
        if base is not None and d == base[0]:
            continue
        if n >= ndata and n % ndata == 0 and (best is None or n > shape[best]):
            best = d
    if best is None:
        return None
    size = shape[best] // ndata
    return best, slice(rank * size, (rank + 1) * size)


def leaf_shard(name: str, shape: Sequence[int], num_data: int, num_model: int, rank: int,
               zero1: bool) -> Optional[Shard]:
    """Rank ``rank``'s block of a leaf (JAX's ``zero1_extend_spec`` of
    ``head_tp_spec``): its model index's ``head_tp_shard``, then, under
    ``zero1``, its data index's ``zero1_shard`` of a free dim; None when
    the rank keeps the whole leaf."""
    d, m = divmod(rank, num_model)
    base = head_tp_shard(name, shape, num_model, m)
    data = zero1_shard(shape, num_data, d, base) if zero1 else None
    return tuple(s for s in (base, data) if s is not None) or None


def shard_plans(mesh: Optional[DataMesh],
                named_params) -> List[Dict[str, Optional[Shard]]]:
    """Every rank's block (``leaf_shard``) of every ``(name, parameter)``,
    in rank order; all None unless the model axis or ZeRO-1 splits
    something (one plan for one rank)."""
    named = [(n, tuple(p.shape)) for n, p in named_params]
    if mesh is None or not (mesh.zero1 or model_active(mesh)):
        return [{n: None for n, _ in named}] * (1 if mesh is None else mesh.world)
    return [{n: leaf_shard(n, shape, mesh.num_data, mesh.num_model, r, mesh.zero1)
             for n, shape in named} for r in range(mesh.world)]


def shard_of(t: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """This rank's block of ``t`` (a view; ``t`` itself when whole)."""
    for dim, sl in shard or ():
        t = t.narrow(dim, sl.start, sl.stop - sl.start)
    return t


def _all_gather_flat(mesh: DataMesh, out: torch.Tensor, mine: torch.Tensor,
                     axis: str = "world") -> None:
    """Every rank's ``mine`` of ``axis`` into ``out``, in rank order: NCCL's
    single-buffer all-gather, gloo's all-gather into the ranks' views of
    ``out``."""
    group, size = _axis(mesh, axis)
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, mine, group=group)
    else:
        dist.all_gather(list(out.view(size, -1).unbind(0)), mine, group=group)


def gather_shards(mesh: DataMesh, pieces: Sequence[Tuple[torch.Tensor, Sequence[int],
                                                         Sequence[Optional[Shard]]]]
                  ) -> List[torch.Tensor]:
    """The whole tensors of ``pieces``, each ``(this rank's block, the whole
    shape, every rank's shard in rank order)``, reassembled from every
    rank's blocks on the blocks' device: one all-gather over every rank of
    one flat buffer per dtype (every rank's blocks of a leaf are the same
    size); a block that several ranks hold (a leaf the other axis does not
    split) is taken once."""
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
            t, shape, shards = pieces[i]
            n = t.numel()
            whole = ranks.new_empty(tuple(shape))
            seen = set()
            for r, shard in enumerate(shards):
                key = tuple((d, sl.start, sl.stop) for d, sl in shard or ())
                if key in seen:
                    continue
                seen.add(key)
                block = shard_of(whole, shard)
                block.copy_(ranks[r, at:at + n].view(block.shape))
            out[i] = whole
            at += n
    return out


def param_all_gather(mesh: Optional[DataMesh], params: Mapping[str, torch.Tensor],
                     plans: Sequence[Mapping[str, Optional[Shard]]]) -> None:
    """The all-gather after a sharded Adam step: overwrite every split
    parameter of ``params`` in place with the ranks' blocks of it (this
    rank's updated block included), from ``plans`` (every rank's,
    ``shard_plans``), one flat buffer per dtype: NCCL's all-gather on the
    card, gloo's through host copies. Whole leaves are left as they are."""
    if not active(mesh):
        return
    names = [n for n in params if any(p.get(n) is not None for p in plans)]
    if not names:
        return
    mine = plans[mesh.rank]
    pieces = [(shard_of(params[n], mine[n]), params[n].shape, [p[n] for p in plans])
              for n in names]
    nbytes = mesh.world * sum(t.numel() * t.element_size() for t, _, _ in pieces)
    with span("cldet.mesh.param_all_gather", nbytes), torch.no_grad():
        for n, whole in zip(names, gather_shards(mesh, pieces)):
            params[n].copy_(whole)


# ----------------------------------------------------------------------
# the model axis: Megatron's f and g, and the gradient gather
# ----------------------------------------------------------------------

def _model_all_reduce(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model group (in ``x``'s dtype)."""
    with span("cldet.mesh.model_all_reduce", x.numel() * x.element_size()):
        buf = x.detach().to(mesh.comm_device, copy=True).contiguous()
        dist.all_reduce(buf, group=mesh.model_group)
        return buf.to(x.device)


def _model_all_gather(mesh: DataMesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's ``x`` joined along ``dim`` in model-index order."""
    with span("cldet.mesh.model_all_gather", x.numel() * x.element_size()):
        mine = x.detach().movedim(dim, 0).contiguous().to(mesh.comm_device)
        flat = mine.new_empty((mesh.num_model,) + tuple(mine.shape))
        _all_gather_flat(mesh, flat.view(-1), mine.view(-1), axis="model")
        return flat.flatten(0, 1).movedim(0, dim).to(x.device)


def _model_slice(mesh: DataMesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    size = x.shape[dim] // mesh.num_model
    return x.narrow(dim, mesh.model_index * size, size)


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: identity forward; backward, the input's gradient
    all-reduced over the model group (a column-parallel layer's input is
    replicated, each rank's gradient a partial sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(ctx.mesh, g), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: the partial outputs of a row-parallel layer
    all-reduced over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _model_all_reduce(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """A split activation joined along its channels (a replicated layer
    after a column-parallel one); backward, this rank's slice of the
    (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _model_all_gather(mesh, x, 1)

    @staticmethod
    def backward(ctx, g):
        return _model_slice(ctx.mesh, g, 1).contiguous(), None


class _ScatterToModel(torch.autograd.Function):
    """This rank's channel slice of a replicated activation (a
    row-parallel layer after a replicated one); backward, the slices'
    gradients joined."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _model_slice(mesh, x, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _model_all_gather(ctx.mesh, g, 1), None


def copy_to_model(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    return _GatherFromModel.apply(x, mesh)


def scatter_to_model(mesh: DataMesh, x: torch.Tensor) -> torch.Tensor:
    return _ScatterToModel.apply(x, mesh)


def gather_model_grads(mesh: Optional[DataMesh],
                       grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The whole gradient of every leaf the model axis splits, joined from
    the model group's slices (rank m's gradient is whole-shaped, right
    only in model index m's slice): one all-gather of one flat buffer per
    dtype over the model group; the other leaves as they are."""
    if not model_active(mesh):
        return dict(grads)
    splits = {n: head_tp_shard(n, g.shape, mesh.num_model, mesh.model_index)
              for n, g in grads.items()}
    names = [n for n, s in splits.items() if s is not None]
    out = dict(grads)
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for n in names:
        by_dtype.setdefault(grads[n].dtype, []).append(n)
    for dtype, group in by_dtype.items():
        # each rank's slice holds 1 / num_model of every leaf of the group
        nbytes = sum(grads[n].numel() for n in group) * grads[group[0]].element_size()
        with span("cldet.mesh.gather_model_grads", nbytes):
            mine = torch.cat([shard_of(grads[n], (splits[n],)).reshape(-1)
                              for n in group]).to(mesh.comm_device)
            flat = mine.new_empty(mesh.num_model * mine.numel())
            _all_gather_flat(mesh, flat, mine, axis="model")
            ranks = flat.to(grads[group[0]].device).view(mesh.num_model, -1)
        at = 0
        for n in group:
            dim, _ = splits[n]
            block = list(grads[n].shape)
            block[dim] //= mesh.num_model
            k = math.prod(block)
            out[n] = torch.cat([ranks[m, at:at + k].view(block)
                                for m in range(mesh.num_model)], dim=dim)
            at += k
    return out


# ----------------------------------------------------------------------
# batches
# ----------------------------------------------------------------------

def proc_shard(mesh: Optional[DataMesh]) -> Dict[str, int]:
    """``BatchLoader`` kwargs of this rank's slice of every global batch:
    its data index's of ``num_data`` (the ranks of a model group read the
    same slice); none without a data axis."""
    if not data_active(mesh):
        return {}
    return {"process_index": mesh.data_index, "process_count": mesh.num_data}


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
