"""The rank model of the port's multi-device paths (port of the data-mesh
and host-grid parts of ``repro.launch.mesh``).

``repro`` runs one controller over a ``jax.sharding.Mesh`` and lets
``shard_map`` place one program on each device.  The port runs one process a
rank under ``torch.distributed`` (SPMD): every rank calls an entry point
with the same global inputs and a :class:`DataMesh`, takes its own row of
the padded ``[P, n_local]`` split, and meets the other ranks only in the
collectives below.  ``mesh is None or mesh.size == 1`` takes the
single-device path, as in ``repro``.

:func:`grid_mesh` lays the ranks of a world mesh out as a (data, model)
grid, ``repro``'s ``make_host_mesh(model)``: a :class:`GridMesh` whose
``data`` and ``model`` views are :class:`DataMesh` es over the rank's column
and row.  :class:`SumOverRanks` and :class:`Replicated` are the autograd
functions that give every rank the gradient of the global value, as
``jax.grad`` takes it through ``shard_map``: a ``psum`` (backward: each
part takes the whole gradient) and an input replicated over a group
(backward: the gradient summed over it).

The backend is chosen once, by a stated rule (:func:`pick_backend`), and
never by trying one and dropping to another:

  * ``"nccl"`` when each rank has a card of its own;
  * ``"gloo"`` when the ranks run on the CPU or share a card.

Under gloo every collective stages a CUDA tensor through pinned host memory
explicitly (copy out, collective on the host copy, copy back), so the code
never depends on which collectives gloo accepts for CUDA tensors.  Under
NCCL the collectives run on the device tensors and nothing waits for the
card.  Each :class:`DataMesh` counts the bytes it sent to other ranks and
the seconds it spent in collectives.

:func:`spawn_ranks` starts ``n`` local ranks (the CLIs' ``--devices N``):
``spawn`` processes (the parent may hold a CUDA context, which a fork would
break), a ``file://`` rendezvous in a temporary directory of their own, one
intra-op thread a rank, the CUDA kernels built once in the parent, and every
rank's return value back to the caller.  A rank that raises or exits non-zero
fails the call with its traceback, after the other ranks are stopped.

The dry run's meshes (``launch.dryrun``).  :func:`make_production_mesh`
gives ``repro``'s 16x16 ``(data, model)`` or 2x16x16 ``(pod, data, model)``
layout as a ``torch.distributed`` ``DeviceMesh`` over a ``fake`` process
group of 256 or 512 ranks, this process rank 0, for as long as its context
lasts: collectives on it return at once and move nothing, so DTensors placed
on it trace a step's ops, shapes and collectives with nothing allocated.
:class:`MeshAxes` and :class:`DeviceGrid` are rank 0's views of such a
mesh's axes, with :class:`DataMesh`'s collectives as functional
collectives, and :func:`shard_map` runs a region of local code (``repro``'s
``shard_map``) on rank 0's shards of DTensors.  The hardware model below
is the H100's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import itertools
import math
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device

__all__ = ["DataMesh", "DeviceGrid", "GridMesh", "MeshAxes", "P", "Replicated",
           "SumOverRanks", "axes_rank", "axis_view", "contiguous_stride", "fake_mesh", "flatten_mesh",
           "grid_mesh", "has_region", "is_dtensor", "make_production_mesh", "mesh_axes", "mesh_size",
           "pick_backend", "placements", "rank_device", "shard_map", "spawn_ranks",
           "spec_entry", "split_axes"]

# ------------------------------------------------------------ hardware model
# H100 SXM5 80GB, 700 W, datasheet (NVIDIA), each rate a GPU
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12          # float32 FLOP/s without tensor cores
HBM_BW = 3.35e12                # HBM3 B/s
HBM_PER_CHIP = 80 * 2 ** 30     # HBM bytes
# one 400 Gb/s NDR port a GPU: a 16-wide axis spans more than one 8-GPU
# NVLink node, so the slowest link a collective on either axis crosses is
# the one between nodes
LINK_BW = 50e9                  # B/s
CHIPS_PER_POD = 256

#: how long a rank waits in a collective for the others before it fails
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)

# the flat-tensor gather: torch 2.13 names it ``all_gather_single`` and
# deprecates the ``all_gather_into_tensor`` older releases have
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def pick_backend(n: int, device: torch.device) -> str:
    """The backend of ``n`` local ranks on ``device``: ``"nccl"`` when the
    host has a card for each rank, ``"gloo"`` when the ranks run on the CPU
    or share the cards."""
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, rank: int, backend: str) -> torch.device:
    """Rank ``rank``'s device: its own card under NCCL, the given one (or
    the card ``rank`` modulo the cards) when gloo ranks share the cards."""
    if device.type != "cuda":
        return device
    if backend == "nccl":
        return torch.device("cuda", rank)
    if device.index is not None:
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclasses.dataclass(eq=False)
class DataMesh:
    """One rank's view of a 1-D data mesh over a process group.

    ``group`` None is the default group.  ``shape`` and ``size`` read as
    ``jax.sharding.Mesh``'s do, so ``run(tokens, cfg, mesh=...)`` keeps
    ``repro``'s signature.
    """

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None
    axis_name: str = "data"
    comm_bytes: int = 0            # bytes this rank sent to other ranks
    _seconds: float = dataclasses.field(default=0.0, repr=False)
    _events: list = dataclasses.field(default_factory=list, repr=False)
    _pinned: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_name: self.size}

    @property
    def comm_seconds(self) -> float:
        """Seconds in collectives: host time of the staged and host ones
        (staging copies included), device time between CUDA events of the
        NCCL ones.  Reading it waits for the NCCL ones still queued."""
        self._fold_events(wait=True)
        return self._seconds

    def _fold_events(self, wait: bool) -> None:
        """Adds the NCCL collectives' event times to the seconds, oldest
        first: all of them (``wait``), or those the card has finished."""
        while self._events and (wait or self._events[0][1].query()):
            start, end = self._events.pop(0)
            end.synchronize()
            self._seconds += start.elapsed_time(end) / 1e3

    # ------------------------------------------------------------ staging
    def _pinned_buffer(self, shape, dtype: torch.dtype, tag: str) -> torch.Tensor:
        """A pinned host tensor of ``shape`` in a buffer kept for ``tag``
        (reused while it is large enough: pinning gigabytes costs a call)."""
        nbytes = math.prod(shape) * dtype.itemsize
        buf = self._pinned.get(tag)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
            self._pinned[tag] = buf
        return buf[:nbytes].view(dtype).view(shape)

    def _run(self, fn, t: torch.Tensor, out_shape, sent: int) -> torch.Tensor:
        """Collective ``fn(out, inp)`` on ``t``, returning ``out`` of
        ``out_shape`` on ``t``'s device.

        Under NCCL it is queued on the card between two CUDA events, and
        nothing waits.  Under gloo a CUDA ``t`` goes through the pinned
        buffers and back; the copy out waits for the card anyway, so the
        card is synchronized first and the seconds counted are the
        collective's, not the queued work that made ``t``.
        """
        t = t.contiguous()
        self.comm_bytes += sent
        if self.backend == "nccl":
            out = torch.empty(out_shape, dtype=t.dtype, device=t.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(out, t)
            end.record()
            self._fold_events(wait=False)
            self._events.append((start, end))
            return out
        if not t.is_cuda:
            t0 = time.perf_counter()
            out = torch.empty(out_shape, dtype=t.dtype)
            fn(out, t)
            self._seconds += time.perf_counter() - t0
            return out
        torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        inp = self._pinned_buffer(t.shape, t.dtype, "in")
        inp.copy_(t)
        out = self._pinned_buffer(out_shape, t.dtype, "out")
        fn(out, inp)
        out = out.to(t.device)          # a blocking copy: the buffer is free after
        self._seconds += time.perf_counter() - t0
        return out

    # --------------------------------------------------------- collectives
    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``all_to_all_single`` with equal splits over the leading axis:
        block ``j`` of ``t`` goes to rank ``j``; block ``j`` of the result
        came from rank ``j``."""
        nbytes = t.numel() * t.element_size()
        return self._run(lambda out, inp: dist.all_to_all_single(
            out, inp, group=self.group), t, t.shape,
            nbytes - nbytes // self.size)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's ``t``, in rank order."""
        nbytes = t.numel() * t.element_size()
        return self._run(lambda out, inp: _all_gather_flat(
            out, inp, group=self.group), t.reshape(-1), (self.size * t.numel(),),
            nbytes * (self.size - 1)).view(self.size, *t.shape)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise ``sum`` or ``max`` of ``t`` over the ranks."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

        def fn(out, inp):
            out.copy_(inp)
            dist.all_reduce(out, op=red, group=self.group)
        return self._run(fn, t, t.shape, t.numel() * t.element_size())

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Block ``rank`` of the elementwise sum of ``t`` [size * m] over the
        ranks: [m].

        An all-to-all of the blocks, then the sum of the blocks received: it
        sends what a reduce-scatter sends, and on gloo ranks sharing a card
        it ran faster than gloo's own reduce-scatter (``chip_smoke.py``
        phase 10 times both).
        """
        blocks = self.all_to_all(t).view(self.size, t.shape[0] // self.size,
                                         *t.shape[1:])
        return blocks.sum(0, dtype=t.dtype)

    def all_gather_rows(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` [n_rank, ...] in rank order, where the ranks'
        row counts differ: one gather of the counts, then one of the rows
        padded to the largest."""
        sizes = self.all_gather(torch.tensor([t.shape[0]], device=t.device)
                                ).view(-1).tolist()
        padded = t.new_zeros((max(max(sizes), 1), *t.shape[1:]))
        padded[:t.shape[0]] = t
        rows = self.all_gather(padded)
        return [rows[p, :n] for p, n in enumerate(sizes)]

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order: one pickle a rank,
        its length and its bytes gathered as tensors (on the card under
        NCCL, on the host under gloo)."""
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
        sizes = self.all_gather(torch.tensor([data.numel()], device=dev)).view(-1).tolist()
        padded = torch.zeros(max(sizes), dtype=torch.uint8, device=dev)
        padded[:data.numel()] = data.to(dev)
        rows = self.all_gather(padded).cpu().numpy()
        return [pickle.loads(row[:n].tobytes()) for row, n in zip(rows, sizes)]

    def sum_ints(self, *values) -> list[int]:
        """The sums over the ranks of a few host or 0-d device integers."""
        t = torch.stack([torch.as_tensor(v, device=self.device).reshape(())
                         .to(torch.int64) for v in values])
        return [int(v) for v in self.all_reduce(t).tolist()]

    def max_int(self, value) -> int:
        """The largest over the ranks of a host or 0-d device integer."""
        t = torch.as_tensor(value, device=self.device).reshape(1).to(torch.int64)
        return int(self.all_reduce(t, "max")[0])


def mesh_size(mesh) -> int:
    """Devices in ``mesh`` (1 for None)."""
    return 1 if mesh is None else int(mesh.size)


# ------------------------------------------------------------------- grid
@dataclasses.dataclass(eq=False)
class GridMesh:
    """One rank's view of a (data, model) grid of ranks.

    World rank r sits at (r // model, r % model).  ``model`` is a
    :class:`DataMesh` over the rank's row (the ranks of its data index),
    ``data`` one over its column (the ranks of its model index); ``world``
    is the whole grid.  ``shape`` and ``size`` read as a two-axis
    ``jax.sharding.Mesh``'s do.
    """

    world: DataMesh
    data: DataMesh
    model: DataMesh

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data.size, "model": self.model.size}

    @property
    def size(self) -> int:
        return self.world.size

    @property
    def rank(self) -> int:
        return self.world.rank

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def comm_bytes(self) -> int:
        """Bytes this rank sent, over the three groups."""
        return self.world.comm_bytes + self.data.comm_bytes + self.model.comm_bytes

    @property
    def comm_seconds(self) -> float:
        return self.world.comm_seconds + self.data.comm_seconds + self.model.comm_seconds


def grid_mesh(world: DataMesh, model: int = 1):
    """``world`` (a mesh over the default group) as a (data, model) grid of
    ``world.size // model`` rows of ``model`` ranks: one ``dist.new_group``
    a row, then one a column, made in that order on every rank, as
    ``new_group`` requires.  With ``model == 1`` or a ``model`` that does not
    divide the ranks it is ``world`` itself, the 1-D data mesh, as
    ``repro``'s ``make_host_mesh`` falls back."""
    n = world.size
    if model <= 1 or n % model:
        return world
    if world.group is not None:
        raise ValueError("grid_mesh lays out the default group's ranks")
    rows = n // model
    i, m = divmod(world.rank, model)
    groups = [dist.new_group(list(range(r * model, (r + 1) * model))) for r in range(rows)]
    groups += [dist.new_group(list(range(c, n, model))) for c in range(model)]

    def view(size: int, rank: int, group, axis: str) -> DataMesh:
        return DataMesh(rank=rank, size=size, device=world.device, backend=world.backend,
                        group=group, axis_name=axis)
    return GridMesh(world, data=view(rows, i, groups[rows + m], "data"),
                    model=view(model, m, groups[i], "model"))


def axis_view(mesh, name: str):
    """The :class:`DataMesh` of ``mesh``'s axis ``name``: a grid's ``data``
    or ``model`` view, a 1-D mesh of that axis itself, or None where
    ``mesh`` has no such axis (one rank along it)."""
    if isinstance(mesh, (GridMesh, DeviceGrid)):
        return getattr(mesh, name)
    return mesh if mesh is not None and mesh.axis_name == name else None


class SumOverRanks(torch.autograd.Function):
    """The all-reduced sum over ``mesh``'s group of a value each rank holds a
    part of (``psum``).  Backward: each rank's part takes the whole
    gradient."""

    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Replicated(torch.autograd.Function):
    """A value every rank of ``mesh``'s group holds whole, each using it on
    its own part of the work.  Backward: the gradient summed over the group
    (``shard_map``'s transpose of an input replicated over those axes)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g), None


# --------------------------------------------------------------- launcher
def _rank_entry(rank: int, n: int, backend: str, device: str, init_file: str,
                result_dir: str, fn, args, kwargs) -> None:
    torch.set_num_threads(1)
    dev = rank_device(torch.device(device), rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=n, timeout=COLLECTIVE_TIMEOUT)
    try:
        mesh = DataMesh(rank=rank, size=n, device=dev, backend=backend)
        out = fn(mesh, *args, **kwargs)
        with open(os.path.join(result_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(n: int, fn, *args, device=None, backend: str | None = None,
                **kwargs) -> list:
    """Run ``fn(mesh, *args, **kwargs)`` on ``n`` local ranks and return
    each rank's return value, in rank order.

    ``fn`` must be importable by name (a module-level function), since each
    rank is a fresh ``spawn`` process.  ``device``: where the ranks run, the
    card unless told otherwise (see :func:`repro_torch.resolve_device`);
    ``backend`` defaults to :func:`pick_backend`.  On a CUDA device the
    kernels are built here once, before the ranks start.  A rank that fails
    raises here (``torch.multiprocessing.ProcessRaisedException`` with its
    traceback, or ``ProcessExitedException`` with its exit code), after the
    other ranks are stopped.
    """
    import torch.multiprocessing as mp

    device = resolve_device(device)
    backend = backend or pick_backend(n, device)
    if device.type == "cuda":
        from repro_torch.kernels import build as kbuild
        kbuild.build()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        mp.start_processes(_rank_entry, nprocs=n, join=True, start_method="spawn",
                           args=(n, backend, str(device),
                                 os.path.join(tmp, "rendezvous"), tmp, fn, args,
                                 kwargs))
        out = []
        for rank in range(n):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


# ------------------------------------------------------------ fake meshes
class P(tuple):
    """A partition spec: one entry a dimension, each an axis name, a tuple
    of axis names (the dimension split over them, major first) or None
    (whole); ``repro``'s ``jax.sharding.PartitionSpec`` as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def placements(mesh, spec: P) -> list:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    each mesh axis a ``Shard(dim)`` of the dimension that names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                out[mesh.mesh_dim_names.index(name)] = Shard(dim)
    return out


def split_axes(t, dim: int) -> tuple:
    """The mesh axes a DTensor's dimension ``dim`` is split over."""
    return tuple(n for n, p in zip(t.device_mesh.mesh_dim_names, t.placements)
                 if p.is_shard() and p.dim == dim)


def axes_rank(mesh, axes: tuple) -> int:
    """This rank's index along the mesh axes ``axes`` read as one (major
    first), and its part of a dimension split over them."""
    names = mesh.mesh_dim_names
    index = 0
    for a in axes:
        index = index * mesh.shape[names.index(a)] + mesh.get_local_rank(a)
    return index


def spec_entry(axes: tuple):
    """A spec entry of ``axes``: None, a name, or a tuple of names."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


#: the regions installed now, by the marked function they stand in for
#: (``launch.regions.installed`` fills it; empty, every call runs as it is)
_REGIONS: dict = {}


def has_region(fn):
    """Marks ``fn`` as a function that a dry run replaces by a region
    (``launch.regions``): while one is installed for it, a call goes to the
    region, which is handed ``fn``; else ``fn`` runs as it is."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        region = _REGIONS.get(call)
        return fn(*args, **kwargs) if region is None else region(fn, *args, **kwargs)
    return call


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


@contextlib.contextmanager
def fake_mesh(shape: tuple, names: tuple, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` (axes ``names``) over a ``fake``
    process group of ``prod(shape)`` ranks, this process rank 0.  The group
    is this context's: it is destroyed on the way out, so it never stays
    behind as the process's default group."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: this process already has a default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        mesh = init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))
        # every view of its axes, made now: a DeviceMesh builds real index
        # tensors, which a fake-tensor trace would refuse
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(names, r):
                mesh_axes(mesh, axes)
        yield mesh
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """``repro``'s production layout over H100s, as a context:
    ``(data, model)`` 16x16, or ``(pod, data, model)`` 2x16x16 with
    ``multi_pod`` (:func:`fake_mesh`)."""
    if multi_pod:
        return fake_mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return fake_mesh((16, 16), ("data", "model"), device_type)


def _funcol(name: str, older: str):
    """A functional collective by its name in torch 2.13 (``*_single``), or
    the older name a release before it has."""
    import torch.distributed._functional_collectives as funcol
    return getattr(funcol, name, None) or getattr(funcol, older)


def _wait(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed._functional_collectives import wait_tensor
    return wait_tensor(t)


def flatten_mesh(mesh, name: str):
    """``mesh``'s devices as one axis ``name``, over the same group."""
    return mesh._flatten(name)


class MeshAxes:
    """Rank 0's view of the axes ``names`` of a ``DeviceMesh`` (several
    axes read as one, major first): :class:`DataMesh`'s collectives, as
    functional collectives on the axes' group.  On a ``fake`` group they
    trace and move nothing."""

    def __init__(self, mesh, names: tuple):
        self.mesh = mesh
        self.names = tuple(names)
        self.group = mesh[names[0]] if len(names) == 1 else flatten_mesh(
            mesh[self.names], "_".join(names))
        self.size = self.group.size()
        self.rank = self.group.get_local_rank()

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        from torch.distributed._functional_collectives import all_to_all_single
        return _wait(all_to_all_single(t.contiguous(), None, None, self.group))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        out = _wait(_funcol("all_gather_single", "all_gather_tensor")(
            t.contiguous(), 0, self.group))
        return out.view(self.size, *t.shape)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        from torch.distributed._functional_collectives import all_reduce
        return _wait(all_reduce(t.contiguous(), op, self.group))

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        return _wait(_funcol("reduce_scatter_single", "reduce_scatter_tensor")(
            t.contiguous(), "sum", 0, self.group))

    def permute(self, t: torch.Tensor, src_dst: list[int]) -> torch.Tensor:
        """``t`` from rank ``i`` goes to rank ``src_dst[i]`` (``ppermute``)."""
        from torch.distributed._functional_collectives import permute_tensor
        return _wait(permute_tensor(t.contiguous(), src_dst, self.group))


def mesh_axes(mesh, names: tuple) -> MeshAxes:
    """The :class:`MeshAxes` of ``mesh``'s axes ``names``, made once a mesh."""
    cache = mesh.__dict__.setdefault("_repro_axes", {})
    if tuple(names) not in cache:
        cache[tuple(names)] = MeshAxes(mesh, tuple(names))
    return cache[tuple(names)]


@dataclasses.dataclass(eq=False)
class DeviceGrid:
    """Rank 0's (data, model) grid on a ``DeviceMesh``, :class:`GridMesh`'s
    interface for the regions ``models.moe`` runs: ``data`` spans the batch
    axes (``pod`` and ``data``, as one), or is None where the batch is not
    split; ``model`` the tensor axis; ``world`` every axis."""

    mesh: object
    data: MeshAxes | None
    model: MeshAxes
    world: MeshAxes

    @classmethod
    def of(cls, mesh, dp_axes) -> "DeviceGrid":
        names = (dp_axes,) if isinstance(dp_axes, str) else tuple(dp_axes or ())
        return cls(mesh, mesh_axes(mesh, names) if names else None,
                   mesh_axes(mesh, ("model",)), mesh_axes(mesh, mesh.mesh_dim_names))

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data.size if self.data else 1, "model": self.model.size}

    @property
    def size(self) -> int:
        return self.world.size

    @property
    def rank(self) -> int:
        return self.world.rank


def shard_map(fn, mesh, in_specs: tuple, out_specs, partial_axes: tuple = ()):
    """``repro``'s ``shard_map`` on DTensors: ``fn`` runs on rank 0's local
    shards of its arguments, each redistributed to its spec in ``in_specs``
    (None: passed as it is), and its outputs (a tensor or a tuple) become
    DTensors of ``out_specs``.

    Gradients flow through.  An input's gradient is taken as placed like
    the input, except over the axes ``partial_axes[i]`` names for argument
    ``i``: there the devices used different parts of a replicated input,
    and its gradient is their sum (``Partial``).  (The MoE and GIN regions
    sum over such axes themselves, with :class:`Replicated`.)"""
    from torch.distributed.tensor import DTensor, Partial

    def local(a, spec, partial):
        if spec is None or not is_dtensor(a):
            return a
        pl = placements(mesh, spec)
        grad = [Partial() if name in partial else p
                for name, p in zip(mesh.mesh_dim_names, pl)]
        return a.redistribute(mesh, pl).to_local(grad_placements=grad)

    def wrap(o, spec):
        pl = placements(mesh, spec)
        shape = list(o.shape)
        for d, entry in enumerate(spec):
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                if name is not None:
                    shape[d] *= mesh.shape[mesh.mesh_dim_names.index(name)]
        # a DTensor's local tensor is laid out as its stride says: contiguous
        return DTensor.from_local(o.contiguous(), mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    def run(*args):
        partial = tuple(partial_axes) + ((),) * (len(args) - len(partial_axes))
        out = fn(*[local(a, s, p) for a, s, p in zip(args, in_specs, partial)])
        if isinstance(out, tuple):
            return tuple(wrap(o, s) for o, s in zip(out, out_specs))
        return wrap(out, out_specs)

    return run


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))
