"""Fleet: the collective strategy API of a process-group job.

Counterpart of ``paddle_tpu/distributed/fleet/__init__.py``.
``init`` takes the degrees of ``DistributedStrategy.hybrid_configs``
(``dp_degree=-1``: the world size over the other degrees) and builds
``HybridCommunicateGroup``: in the port the degrees lay the job's ranks
out as ``mesh.AXIS_ORDER`` (rank-major, as JAX's mesh lays out its
devices), and each rank gets a process group along its dp and sharding
axes (``get_data_parallel_group``, ``get_sharding_parallel_group``); the
HCG's mesh is this rank's device, one entry a rank.
``distributed_model`` returns a ``DataParallel`` when dp > 1 and, under
sharding stage 3, marks the model (its parameters rest as regions and
are gathered at its forward, ``sharding.mark_stage3``).
``distributed_optimizer`` turns ``sharding_configs["stage"]`` into
``group_sharded_parallel``'s level over the sharding group (else the
dp group), then wraps ``gradient_merge`` and ``amp`` as JAX does.
``worker_num``/``worker_index``/``is_first_worker``/``barrier_worker``
ride the process group. The meta-parallel layers
(``ColumnParallelLinear`` and the rest, ``PipelineLayer``) and
``fleet.utils.recompute`` come with ``ROADMAP.md`` A.6 (e)."""
from __future__ import annotations


import numpy as np

from .. import communication as C
from ..mesh import (AXIS_ORDER, HybridCommunicateGroup,
                    get_hybrid_communicate_group)
from ..parallel import DataParallel
from . import meta_optimizers
from . import utils                                        # noqa: F401

__all__ = ["init", "DistributedStrategy", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "get_strategy", "worker_num", "worker_index", "is_first_worker",
           "barrier_worker", "meta_optimizers", "utils"]

_FLEET = {"initialized": False, "strategy": None, "hcg": None}
_DEGREES = ("dp_degree", "mp_degree", "pp_degree", "sharding_degree",
            "sep_degree")


class DistributedStrategy:
    """Plain attributes (the reference's is protobuf-backed). Assigning
    ``hybrid_configs`` merges into the current one."""

    def __init__(self):
        self.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1}
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.tensor_parallel_configs = {}
        self.find_unused_parameters = False

    def __setattr__(self, k, v):
        if k == "hybrid_configs" and hasattr(self, "hybrid_configs"):
            merged = dict(self.__dict__.get("hybrid_configs", {}))
            merged.update(v)
            object.__setattr__(self, k, merged)
        else:
            object.__setattr__(self, k, v)


def _axis_groups(dims: dict) -> dict:
    """A process group along each of the dp and sharding axes of degree
    above 1, for this rank: the ranks whose coordinates differ only
    there. Every rank creates every group, in one order (ids agree)."""
    shape = [dims[a] for a in AXIS_ORDER]
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    me = C._my_rank()
    out = {}
    for axis in ("dp", "sharding"):
        i = AXIS_ORDER.index(axis)
        if shape[i] <= 1:
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for ranks in lines:
            g = C.new_group([int(r) for r in ranks])
            if me in g.ranks:
                out[axis] = g
    return out


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO", device=None):
    """Take the strategy's degrees over the job's world (module
    docstring). ``device``: the HCG mesh's device, by default the one
    ``init_parallel_env`` chose, else the current CUDA device (pass
    ``device="cpu"`` on the host)."""
    from ...device import resolve_device
    from ..parallel import ParallelEnv
    if strategy is None:
        strategy = DistributedStrategy()
    h = strategy.hybrid_configs
    world = C._world_size()
    degrees = {k: int(h.get(k, 1)) for k in _DEGREES}
    known = 1
    for k, v in degrees.items():
        if v > 0 and k != "dp_degree":
            known *= v
    if degrees["dp_degree"] in (-1, 0):
        degrees["dp_degree"] = max(world // known, 1)
    dims = {k[:-len("_degree")]: v for k, v in degrees.items()}
    total = int(np.prod(list(dims.values())))
    if total != world:
        raise ValueError(f"hybrid degrees {dims} need {total} ranks; the "
                         f"job has {world}")
    dev = ParallelEnv().device or resolve_device(device)
    hcg = HybridCommunicateGroup(
        dp_degree=dims["dp"], mp_degree=dims["mp"], pp_degree=dims["pp"],
        sharding_degree=dims["sharding"], sep_degree=dims["sep"],
        devices=[dev] * total)
    hcg._groups = _axis_groups(dims)
    _FLEET.update(initialized=True, strategy=strategy, hcg=hcg)
    return None


def _require_init():
    if not _FLEET["initialized"]:
        raise RuntimeError("call fleet.init(...) first")


def get_strategy():
    return _FLEET["strategy"]


def _stage(strategy, hcg) -> int:
    if strategy is not None and getattr(strategy, "sharding", False):
        return int(strategy.sharding_configs.get("stage", 1))
    return 1 if hcg.axis_size("sharding") > 1 else 0


def distributed_model(model):
    """A ``DataParallel`` over the dp group when dp > 1, else the model;
    under sharding stage 3 the model is marked first (its parameters
    rest as regions once ``distributed_optimizer`` shards them)."""
    _require_init()
    hcg = _FLEET["hcg"]
    if _stage(_FLEET["strategy"], hcg) >= 3:
        from ..sharding import mark_stage3
        mark_stage3(model)
    if hcg.axis_size("dp") > 1:
        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model


def distributed_optimizer(optimizer, strategy=None):
    """ZeRO from ``sharding_configs["stage"]`` (1 ``os``, 2 ``os_g``, 3
    ``p_g_os``; an active sharding axis alone means stage 1), then the
    gradient-merge and AMP wrappers the strategy's flags ask for."""
    _require_init()
    strategy = strategy or _FLEET["strategy"]
    stage = _stage(strategy, _FLEET["hcg"])
    if stage:
        from ..sharding import group_sharded_parallel
        level = {1: "os", 2: "os_g", 3: "p_g_os"}[min(stage, 3)]
        _, optimizer, _ = group_sharded_parallel(None, optimizer, level)
    if strategy is not None and getattr(strategy, "gradient_merge", False):
        cfg = getattr(strategy, "gradient_merge_configs", {}) or {}
        optimizer = meta_optimizers.GradientMergeOptimizer(
            optimizer, k_steps=int(cfg.get("k_steps", 1)),
            avg=bool(cfg.get("avg", True)))
    if strategy is not None and getattr(strategy, "amp", False):
        cfg = getattr(strategy, "amp_configs", {}) or {}
        optimizer = meta_optimizers.AMPOptimizer(
            optimizer, dtype=cfg.get("dtype", "bfloat16"),
            init_loss_scaling=float(cfg.get("init_loss_scaling", 2.**15)))
    return optimizer


def worker_num():
    return C._world_size()


def worker_index():
    return C._my_rank()


def is_first_worker():
    return C._my_rank() == 0


def barrier_worker():
    C.barrier()
