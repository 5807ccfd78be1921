"""The device mesh: named parallelism axes over ``torch.device``s.

Counterpart of ``paddle_tpu/distributed/mesh.py``. The JAX package lays
its parallelism dimensions out as the named axes of one
``jax.sharding.Mesh``; a "communication group" is (mesh, axis name) and
one controller drives every device of it. The port keeps that
single-controller design: :class:`Mesh` is the axis names over an
ndarray of ``torch.device``, and the sharded programs
(``serving.tp``) run each shard's part on its device from one Python
process.

The default devices are every visible CUDA device. An explicit list may
name a device more than once (``[torch.device("cuda:0")] * 2``, or
``["cpu"] * 8``): each entry is one logical device of the mesh, as
XLA's simulated host devices are in the JAX package's tests. On one
card a 2-way mesh then runs both shards there.

``NamedSharding(mesh, axes)`` splits dim 0 of a tensor over mesh axes
(JAX's ``NamedSharding(mesh, P(axes))``), the placement
``io.device_prefetch(sharding=)`` gives each device's piece by.

``HybridCommunicateGroup`` builds and sets a mesh; in a job of several
processes ``fleet.init`` also gives it this rank's process group along
each of the dp, sharding and mp axes of degree above 1
(``get_data_parallel_group``, ``get_sharding_parallel_group``,
``get_model_parallel_group``: None where the degree is 1). Its rank
getters give this process's coordinate along an axis of the
``AXIS_ORDER`` grid of the job's ranks (one rank a device, as JAX's
``_axis_rank`` reads a process's position in the mesh).

A tensor-parallel split is a partition spec, a tuple with ``"mp"`` at
the split dimension (``LlamaForCausalLM.partition_specs()``, in the
port's layout): :func:`spec_dim` finds that dimension and
:func:`spec_piece` takes one rank's slice, the one rule that both the
serving shards (``serving.tp``) and the training split
(``fleet.distributed_model``) follow."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["AXIS_ORDER", "Mesh", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "build_device_mesh",
           "CommunicateTopology", "set_current_mesh", "get_current_mesh",
           "axis_devices", "NamedSharding", "spec_dim", "spec_piece"]

# axis order: outermost (slowest link) -> innermost (fastest link), as in
# the JAX package: pp stages communicate least per step, mp/sep most
AXIS_ORDER = ("pp", "dp", "sharding", "sep", "mp")

_HCG: Optional["HybridCommunicateGroup"] = None
_CURRENT_MESH: Optional["Mesh"] = None


class Mesh:
    """Named axes over an ndarray of ``torch.device`` (JAX's
    ``jax.sharding.Mesh``): ``devices`` has one dimension per name of
    ``axis_names``; ``shape`` maps each name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for "
                             f"{len(axis_names)} axis names {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def spec_dim(spec) -> Optional[int]:
    """The split dimension of a partition spec (the first entry that
    names an axis), or None for a replicated one (None or all None)."""
    return next((i for i, e in enumerate(spec or ()) if e), None)


def spec_piece(t: torch.Tensor, spec, index: int, degree: int
               ) -> torch.Tensor:
    """Slice ``index`` of ``degree`` equal slices of ``t`` along the
    dimension ``spec`` splits (a view), or ``t`` itself for a
    replicated spec or a degree of 1. A dimension the degree does not
    divide raises."""
    dim = spec_dim(spec)
    if dim is None or degree == 1:
        return t
    if t.shape[dim] % degree:
        raise ValueError(f"dim {dim} of a {tuple(t.shape)} tensor does not "
                         f"split into {degree} equal slices")
    n = t.shape[dim] // degree
    return t.narrow(dim, index * n, n)


def set_current_mesh(mesh: Optional[Mesh]):
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def get_current_mesh() -> Optional[Mesh]:
    return _CURRENT_MESH


def build_device_mesh(axis_dims: dict, devices=None,
                      allow_subset: bool = False) -> Mesh:
    """axis_dims: {"dp": 2, "mp": 4, ...}; missing axes get degree 1.
    ``devices``: the mesh's devices in linear (row-major over
    :data:`AXIS_ORDER`) order, default every visible CUDA device; an
    entry may repeat (one logical device each). With ``allow_subset``
    the first prod(dims) devices are used; otherwise a size mismatch is
    an error (silently idling devices hides configuration typos)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices= (e.g. "
                "[\"cpu\"] * 8) to build a mesh of CPU devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    dims = [int(axis_dims.get(a, 1)) for a in AXIS_ORDER]
    unknown = set(axis_dims) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; expected "
                         f"names from {AXIS_ORDER}")
    total = int(np.prod(dims))
    if total > len(devices) or (total < len(devices) and not allow_subset):
        raise ValueError(
            f"topology {dict(zip(AXIS_ORDER, dims))} needs {total} devices, "
            f"have {len(devices)} (pass allow_subset=True to use a prefix)")
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape(dims), AXIS_ORDER)


class CommunicateTopology:
    """The topology's names and degrees (the JAX package's parity shim
    of ``fleet.base.topology.CommunicateTopology``)."""

    def __init__(self, hybrid_group_names, dims):
        self._names = list(hybrid_group_names)
        self._dims = list(dims)

    def get_hybrid_group_names(self):
        return self._names

    def get_dim(self, name):
        return self._dims[self._names.index(name)]

    def world_size(self):
        return int(np.prod(self._dims))


class HybridCommunicateGroup:
    """Builds the dp x pp x sharding x sep x mp mesh and makes it the
    current one (what ``serving.tp`` shards over by default)."""

    def __init__(self, dp_degree=1, mp_degree=1, pp_degree=1,
                 sharding_degree=1, sep_degree=1, devices=None,
                 allow_subset=False):
        self._dims = {"dp": dp_degree, "mp": mp_degree, "pp": pp_degree,
                      "sharding": sharding_degree, "sep": sep_degree}
        self.mesh = build_device_mesh(self._dims, devices,
                                      allow_subset=allow_subset)
        self._topo = CommunicateTopology(list(AXIS_ORDER),
                                         [self._dims.get(a, 1)
                                          for a in AXIS_ORDER])
        self._groups = {}       # axis -> process group (fleet.init)
        global _HCG
        _HCG = self
        set_current_mesh(self.mesh)

    def axis_size(self, axis: str) -> int:
        return self._dims.get(axis, 1)

    # -- fleet.topology's API (JAX ``mesh.py:122-216``) --------------------
    def get_parallel_mode(self):
        if self._dims["pp"] > 1:
            return "pipeline_parallel"
        if self._dims["sharding"] > 1:
            return "sharding_parallel"
        if self._dims["mp"] > 1:
            return "tensor_parallel"
        return "data_parallel"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        from .communication import _my_rank
        return _my_rank()

    def _coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` of the job's
        ``AXIS_ORDER`` grid (rank-major, one rank a device)."""
        shape = [self._dims.get(a, 1) for a in AXIS_ORDER]
        rank = self.get_global_rank()
        if rank >= int(np.prod(shape)):
            return 0
        return int(np.unravel_index(rank, shape)[AXIS_ORDER.index(axis)])

    def _src_rank(self, axis: str) -> int:
        """The global rank of coordinate 0 along ``axis`` with this
        rank's other coordinates: the first rank of its group there."""
        shape = [self._dims.get(a, 1) for a in AXIS_ORDER]
        stride = int(np.prod(shape[AXIS_ORDER.index(axis) + 1:]))
        return self.get_global_rank() - self._coord(axis) * stride

    def get_data_parallel_world_size(self):
        return self._dims["dp"]

    def get_model_parallel_world_size(self):
        return self._dims["mp"]

    def get_pipe_parallel_world_size(self):
        return self._dims["pp"]

    def get_sharding_parallel_world_size(self):
        return self._dims["sharding"]

    def get_sep_parallel_world_size(self):
        return self._dims["sep"]

    def get_data_parallel_rank(self):
        return self._coord("dp")

    def get_model_parallel_rank(self):
        return self._coord("mp")

    def get_stage_id(self):
        return self._coord("pp")

    def get_sharding_parallel_rank(self):
        return self._coord("sharding")

    def get_sep_parallel_rank(self):
        return self._coord("sep")

    def get_data_parallel_group(self):
        return self._groups.get("dp")

    def get_model_parallel_group(self):
        return self._groups.get("mp")

    def get_sharding_parallel_group(self):
        return self._groups.get("sharding")

    def get_pipe_parallel_group(self):
        return self._groups.get("pp")

    def get_sep_parallel_group(self):
        return self._groups.get("sep")

    def get_data_parallel_group_src_rank(self):
        return self._src_rank("dp")

    def get_model_parallel_group_src_rank(self):
        return self._src_rank("mp")

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._dims["pp"] - 1


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _HCG


def axis_devices(mesh: Mesh, axes: Sequence[str]) -> list:
    """The devices of ``mesh`` along ``axes`` in linear-index order
    (outer-major over ``axes`` in mesh order), at index 0 of every other
    axis: one device per shard of a program sharded over ``axes``. (A
    JAX ``shard_map`` also runs the replicas along the other axes, which
    compute the same values; one controller needs only one of them.)"""
    names = mesh.axis_names
    index = tuple(slice(None) if a in axes else 0 for a in names)
    return list(mesh.devices[index].reshape(-1))


class NamedSharding:
    """Dim 0 split over mesh axes, replicated over the others: JAX's
    ``NamedSharding(mesh, P(axes))`` for a leading-dim spec. ``axes`` is
    one axis name or a tuple of them (outer-major in mesh order, as
    ``P(("dp", "mp"))``). :meth:`pieces` gives one piece of a tensor per
    mesh device, in the mesh's linear order: the rows of that device's
    coordinate along ``axes``, which is what ``jax.device_put`` leaves on
    the device as its addressable shard."""

    def __init__(self, mesh: Mesh, axes):
        self.mesh = mesh
        self.axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in self.axes if a not in mesh.axis_names]
        if unknown:
            raise ValueError(f"axes {unknown} are not axes of {mesh}")

    def devices(self) -> list:
        """The mesh's devices in linear order, each CUDA one with its
        index (``"cuda"`` is the current card)."""
        from ..device import resolve_device
        return [resolve_device(d) if d.type == "cuda" else d
                for d in self.mesh.devices.reshape(-1)]

    def pieces(self, t: torch.Tensor) -> list:
        names = self.mesh.axis_names
        sizes = [self.mesh.shape[a] for a in self.axes]
        n = int(np.prod(sizes))
        if t.dim() == 0 or t.shape[0] % n:
            raise ValueError(f"dim 0 of a {tuple(t.shape)} tensor does not "
                             f"split into {n} pieces over {self.axes}")
        rows = t.shape[0] // n
        out = []
        for coord in np.ndindex(*self.mesh.devices.shape):
            k = 0
            for a, size in zip(self.axes, sizes):
                k = k * size + coord[names.index(a)]
            out.append(t[k * rows:(k + 1) * rows])
        return out

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.axes})"
