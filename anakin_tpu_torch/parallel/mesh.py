"""The mesh of ranks: the port of `anakin_tpu/parallel/mesh.py`.

The JAX package drives a `jax.sharding.Mesh` of devices from one process
and lets XLA's GSPMD insert the collectives.  The port is SPMD over
`torch.distributed`: one process per rank, a `Mesh` that lays the ranks
out on named axes (`data`, `model`, and `dcn` on a hybrid mesh), one
process group per row of each axis, and collectives that the port's
executor issues itself through the mesh:

  * `all_gather`, `all_gather_async` (a handle that waits at the consumer),
    `all_reduce` (sum), `broadcast`, `broadcast_object` (host values, such
    as a scheduler's plan), and `ring_send_recv` (one step of a ring);
  * every data collective over two ranks or more is recorded (`records`:
    kind, dtype, shape, result bytes, group size) for `parallel.scaling`.

Every rank must build the same meshes in the same order: the process
groups are made when a mesh is built, and making a group is a collective
of the whole world.  A mesh built where `torch.distributed` is not
initialized has its shape but no groups (its collectives raise).

Where the backend refuses a CUDA tensor for a collective (gloo takes some
on CUDA only), the mesh stages it through pinned host memory, for the
kinds named in `staged` only: the caller probes (`probe_cuda_collectives`)
and chooses; nothing is staged unasked.  The backend is the caller's choice
too (`distributed.initialize`): NCCL where each rank has its own card,
gloo where ranks share one.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Mesh", "Spec", "make_mesh", "make_hybrid_mesh", "replicated",
           "batch_axes", "batch_size_of", "probe_cuda_collectives",
           "DATA_AXIS", "MODEL_AXIS", "DCN_AXIS", "COLLECTIVE_KINDS"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"

# the kinds a mesh issues, as `staged` names them
COLLECTIVE_KINDS = ("all_gather", "all_reduce", "broadcast", "send_recv")

# torch dtype -> the HLO element type name the scaling records use
_HLO_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float64: "f64", torch.int8: "s8",
              torch.uint8: "u8", torch.int32: "s32", torch.int64: "s64",
              torch.bool: "pred"}

Axes = Union[str, Tuple[str, ...]]


class Spec(tuple):
    """A partition spec: one entry per leading dim of a tensor, each None
    (whole), an axis name, or a tuple of axis names (split over their
    product, the first outermost).  `Spec()` is replicated.  It compares
    equal to `tuple(jax.sharding.PartitionSpec(...))`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):  # pickle and copy rebuild it from its entries
        return tuple(self)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


class _Handle:
    """A pending all-gather: `wait()` gives the gathered tensor."""

    def __init__(self, work, parts, finish):
        self._work, self._parts, self._finish = work, parts, finish
        self._out = None

    def wait(self) -> torch.Tensor:
        if self._out is None:
            self._work.wait()
            self._out = self._finish(self._parts)
        return self._out


class Mesh:
    """Ranks on named axes.  `devices` is the grid of global ranks (the
    name is the JAX mesh's), `shape` {axis: size}, `rank` this process's
    rank, `coords` {axis: index} (None off the mesh)."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.staged = frozenset()
        self.records: List[Dict[str, Any]] = []
        self.rank = _dist().get_rank() if _initialized() else 0
        where = np.argwhere(self.devices == self.rank)
        self.coords = (None if len(where) == 0 else
                       dict(zip(self.axis_names, (int(i) for i in where[0]))))
        self._groups: Dict[Tuple[str, ...], Tuple[Any, List[int]]] = {}
        if _initialized():
            self._make_groups()

    # ------------------------------------------------------------- layout
    def _keys(self) -> List[Tuple[str, ...]]:
        keys = [(a,) for a in self.axis_names]
        for k in (batch_axes(self), self.axis_names):
            if len(k) > 1 and k not in keys:
                keys.append(tuple(k))
        return keys

    def _make_groups(self) -> None:
        dist = _dist()
        for key in self._keys():
            idx = [self.axis_names.index(a) for a in key]
            rest = [i for i in range(len(self.axis_names)) if i not in idx]
            grid = np.transpose(self.devices, rest + idx).reshape(
                -1, int(np.prod([self.devices.shape[i] for i in idx])))
            for row in grid:
                ranks = [int(r) for r in row]
                if len(ranks) < 2:
                    continue
                group = dist.new_group(sorted(ranks))
                if self.rank in ranks:
                    self._groups[key] = (group, ranks)

    def _key(self, axis: Axes) -> Tuple[str, ...]:
        return (axis,) if isinstance(axis, str) else tuple(axis)

    def axis_size(self, axis: Axes) -> int:
        return int(np.prod([self.shape[a] for a in self._key(axis)]))

    def axis_index(self, axis: Axes) -> int:
        """This rank's index along `axis` (row-major over a tuple)."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not on this mesh")
        i = 0
        for a in self._key(axis):
            i = i * self.shape[a] + self.coords[a]
        return i

    def _group(self, axis: Axes):
        key = self._key(axis)
        if key not in self._groups:
            if not _initialized():
                raise RuntimeError("this mesh was built without an initialized "
                                   "torch.distributed: it has no collectives")
            raise ValueError(f"no group along {key} on rank {self.rank}")
        return self._groups[key]

    def stage(self, kinds) -> "Mesh":
        """Collectives of these kinds (`COLLECTIVE_KINDS`) take CUDA tensors
        through pinned host memory."""
        unknown = set(kinds) - set(COLLECTIVE_KINDS)
        if unknown:
            raise ValueError(f"unknown collective kinds {sorted(unknown)}")
        self.staged = frozenset(kinds)
        return self

    # ---------------------------------------------------------- recording
    def _record(self, kind: str, t: torch.Tensor, shape, n: int) -> None:
        if n < 2:  # a row of one rank moves nothing
            return
        self.records.append({
            "kind": kind, "dtype": _HLO_DTYPE.get(t.dtype, "f32"),
            "shape": tuple(int(s) for s in shape),
            "result_bytes": int(np.prod(shape)) * t.element_size(),
            "group_size": n})

    def take_records(self) -> List[Dict[str, Any]]:
        out, self.records = self.records, []
        return out

    # -------------------------------------------------------- host staging
    def _out(self, kind: str, t: torch.Tensor):
        """(tensor the backend takes, function back to t's device)."""
        if kind in self.staged and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host, (lambda h, d=t.device: h.to(d, non_blocking=True))
        return t, (lambda h: h)

    # --------------------------------------------------------- collectives
    def all_gather_async(self, t: torch.Tensor, axis: Axes = MODEL_AXIS,
                         dim: int = 0) -> _Handle:
        """Start gathering every rank's `t` along `axis`, joined on `dim` in
        the axis's order; the handle's `wait()` gives the result."""
        n = self.axis_size(axis)
        dim = dim % t.dim()
        shape = list(t.shape)
        shape[dim] *= n
        self._record("all-gather", t, shape, n)
        if n == 1:
            return _Handle(_Done(), [t], lambda parts: parts[0])
        group, ranks = self._group(axis)
        src, back = self._out("all_gather", t.contiguous())
        parts = [torch.empty_like(src) for _ in ranks]
        work = _dist().all_gather(parts, src, group=group, async_op=True)
        order = sorted(ranks)
        pos = [order.index(r) for r in ranks]

        def finish(ps):
            return back(torch.cat([ps[i] for i in pos], dim=dim))

        return _Handle(work, parts, finish)

    def all_gather(self, t: torch.Tensor, axis: Axes = MODEL_AXIS,
                   dim: int = 0) -> torch.Tensor:
        return self.all_gather_async(t, axis, dim).wait()

    def all_reduce(self, t: torch.Tensor, axis: Axes = MODEL_AXIS
                   ) -> torch.Tensor:
        """The sum of every rank's `t` along `axis` (a new tensor)."""
        n = self.axis_size(axis)
        self._record("all-reduce", t, t.shape, n)
        if n == 1:
            return t
        src, back = self._out("all_reduce", t.contiguous().clone())
        _dist().all_reduce(src, group=self._group(axis)[0])
        return back(src)

    def broadcast(self, t: torch.Tensor, axis: Axes = MODEL_AXIS,
                  index: int = 0) -> torch.Tensor:
        """Rank `index` of the row's `t` on every rank of it."""
        if self.axis_size(axis) == 1:
            return t
        group, ranks = self._group(axis)
        src, back = self._out("broadcast", t.contiguous().clone())
        _dist().broadcast(src, src=ranks[index], group=group)
        return back(src)

    def broadcast_object(self, obj: Any, axis: Axes = None,
                         index: int = 0) -> Any:
        """Rank `index`'s picklable `obj` on every rank of the row along
        `axis` (default every axis: the whole mesh)."""
        axis = self.axis_names if axis is None else axis
        if self.axis_size(axis) == 1:
            return obj
        group, ranks = self._group(axis)
        box = [obj]
        _dist().broadcast_object_list(box, src=ranks[index], group=group)
        return box[0]

    def ring_send_recv(self, t: torch.Tensor, axis: Axes = MODEL_AXIS,
                       shift: int = 1):
        """Post one ring step: send `t` to the rank `shift` places on along
        `axis` and receive the same shape from the one `shift` places back.
        Returns `wait() -> received`, to call after the work that overlaps
        the transfer."""
        n = self.axis_size(axis)
        self._record("collective-permute", t, t.shape, n)
        if n == 1:
            return lambda: t
        dist = _dist()
        group, ranks = self._group(axis)
        i = self.axis_index(axis)
        src, _ = self._out("send_recv", t.contiguous())
        buf = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, ranks[(i + shift) % n], group),
               dist.P2POp(dist.irecv, buf, ranks[(i - shift) % n], group)]
        works = dist.batch_isend_irecv(ops)
        dev = t.device

        def wait() -> torch.Tensor:
            for w in works:
                w.wait()
            return buf.to(dev, non_blocking=True) if buf.device != dev else buf

        return wait


class _Done:
    def wait(self):
        return None


def _world() -> Tuple[int, int]:
    if _initialized():
        dist = _dist()
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(devices: Optional[Sequence[int]] = None,
              data: Optional[int] = None, model: int = 1) -> Mesh:
    """A (data, model) mesh over the given ranks (default every rank of the
    world), `model` innermost (the tensor-parallel degree; a row of it
    should sit on one host's fastest links); `data` defaults to
    n_ranks // model."""
    devices = list(devices if devices is not None else range(_world()[0]))
    n = len(devices)
    if n % model != 0:
        raise ValueError(f"model={model} does not divide device count {n}")
    data = data if data is not None else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(np.asarray(devices).reshape(data, model),
                (DATA_AXIS, MODEL_AXIS))


def _hosts(n: int) -> int:
    """Hosts of an n-rank world: n over the ranks a host runs
    (`LOCAL_WORLD_SIZE`, as torchrun sets it; one host without it)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n) or n)
    return max(1, n // max(1, local))


def make_hybrid_mesh(dcn: Optional[int] = None, data: Optional[int] = None,
                     model: int = 1,
                     devices: Optional[Sequence[int]] = None) -> Mesh:
    """A (dcn, data, model) mesh: `dcn` spans hosts (one group a host by
    default) and should carry batch parallelism only; `data` defaults to
    the ranks left per group over `model`.  A host's ranks are contiguous
    (the torchrun layout), so they fill the inner axes."""
    devices = list(devices if devices is not None else range(_world()[0]))
    n = len(devices)
    dcn = dcn if dcn is not None else _hosts(n)
    if n % (dcn * model) != 0:
        raise ValueError(f"dcn={dcn} * model={model} does not divide {n}")
    data = data if data is not None else n // (dcn * model)
    if dcn * data * model != n:
        raise ValueError(f"mesh {dcn}x{data}x{model} != {n} devices")
    return Mesh(np.asarray(devices).reshape(dcn, data, model),
                (DCN_AXIS, DATA_AXIS, MODEL_AXIS))


def replicated(mesh: Mesh) -> Spec:
    return Spec()


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes that carry the batch dimension: (dcn, data) on a
    hybrid mesh, (data,) on a flat one."""
    return tuple(a for a in (DCN_AXIS, DATA_AXIS) if a in mesh.shape)


def batch_size_of(mesh: Mesh) -> int:
    """Total batch-parallel degree of the mesh."""
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def probe_cuda_collectives(mesh: Mesh, device, axis: Axes = MODEL_AXIS,
                           kinds: Sequence[str] = COLLECTIVE_KINDS
                           ) -> Dict[str, bool]:
    """{kind: True where the backend takes a CUDA tensor for it} along
    `axis`, each of `kinds` tried once on a small tensor by every rank of
    the row, unstaged.  Nothing is recorded, nothing staged.

    A kind the backend refuses with an error gives False.  gloo refuses
    CUDA tensors for send / recv otherwise: it hands the device pointer to
    its socket, and the process aborts ("writev ... Bad address").  So
    leave a kind that may abort out of `kinds` and stage it unprobed
    (`chip_smoke.py` phase 24 does so for send / recv under gloo)."""
    dev = torch.device(device)
    out = {}
    saved, mesh.staged = mesh.staged, frozenset()
    n_records = len(mesh.records)
    n = mesh.axis_size(axis)
    try:
        for kind in kinds:
            t = torch.full((4,), float(mesh.axis_index(axis) + 1), device=dev)
            try:
                if kind == "all_gather":
                    ok = mesh.all_gather(t, axis).shape[0] == 4 * n
                elif kind == "all_reduce":
                    ok = float(mesh.all_reduce(t, axis)[0]) == n * (n + 1) / 2
                elif kind == "broadcast":
                    ok = float(mesh.broadcast(t, axis)[0]) == 1.0
                else:
                    got = mesh.ring_send_recv(t, axis)()
                    ok = float(got[0]) == float(
                        (mesh.axis_index(axis) - 1) % n + 1)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            except RuntimeError:
                ok = False
            out[kind] = bool(ok)
    finally:
        mesh.staged = saved
        del mesh.records[n_records:]
    return out
