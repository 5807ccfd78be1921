"""Fleet: the collective strategy API of a process-group job.

Counterpart of ``paddle_tpu/distributed/fleet/__init__.py``.
``init`` takes the degrees of ``DistributedStrategy.hybrid_configs``
(``dp_degree=-1``: the world size over the other degrees) and builds
``HybridCommunicateGroup``: in the port the degrees lay the job's ranks
out as ``mesh.AXIS_ORDER`` (rank-major, as JAX's mesh lays out its
devices), and each rank gets a process group along each of its dp,
sharding and mp axes of degree above 1 (``get_data_parallel_group``,
``get_sharding_parallel_group``, ``get_model_parallel_group``); the
HCG's mesh is this rank's device, one entry a rank. ``pp_degree`` and
``sep_degree`` above 1 raise ``NotImplementedError`` on every rank
before any group is made (``ROADMAP.md`` A.6 (e2), (e3)), and so does
mp beside a sharding degree above 1 (A.6 (e5)).

``distributed_model`` splits the model over the mp group when mp > 1:
each parameter that the model's ``partition_specs()`` (or a
meta-parallel layer) marks keeps this rank's slice in place
(``mesh.spec_piece``), the replicated ones stay whole, and the model's
forward then runs the mp collectives (``meta_parallel``, ``mp_ops``).
A model that nothing splits is refused at mp > 1. It then returns a
``DataParallel`` over the dp group when dp > 1, else the model (JAX
returns the model itself for mp); under sharding stage 3 it marks the
model (its parameters rest as regions and are gathered at its forward,
``sharding.mark_stage3``). ``distributed_optimizer`` turns
``sharding_configs["stage"]`` into ``group_sharded_parallel``'s level
over the sharding group (else the dp group), then wraps
``gradient_merge`` and ``amp`` as JAX does.
``worker_num``/``worker_index``/``is_first_worker``/``barrier_worker``
ride the process group. ``meta_parallel`` holds the tensor-parallel
layers and ``utils`` the gradient sync and ``recompute``;
``PipelineLayer`` comes with A.6 (e2)."""
from __future__ import annotations


import numpy as np

from .. import communication as C
import torch

from ..mesh import (AXIS_ORDER, HybridCommunicateGroup,
                    get_hybrid_communicate_group, spec_dim, spec_piece)
from ..parallel import DataParallel
from . import meta_optimizers
from . import meta_parallel
from . import mp_ops
from . import utils                                        # noqa: F401
from .meta_parallel import (ColumnParallelLinear,          # noqa: F401
                            ParallelCrossEntropy, RowParallelLinear,
                            VocabParallelEmbedding)

__all__ = ["init", "DistributedStrategy", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "get_strategy", "worker_num", "worker_index", "is_first_worker",
           "barrier_worker", "meta_optimizers", "meta_parallel", "utils",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy"]

_FLEET = {"initialized": False, "strategy": None, "hcg": None}
_DEGREES = ("dp_degree", "mp_degree", "pp_degree", "sharding_degree",
            "sep_degree")
# the axes of degree above 1 that the port builds a process group along
_GROUP_AXES = ("dp", "sharding", "mp")


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
    """A process group along each of the dp, sharding and mp axes of
    degree above 1, for this rank: the ranks whose coordinates differ
    only there. Every rank creates every group, in one order (ids
    agree)."""
    shape = [dims[a] for a in AXIS_ORDER]
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    me = C._my_rank()
    out = {}
    for axis in _GROUP_AXES:
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
    # refused before any group is made, on every rank alike, so that the
    # job stops at once instead of training unsplit copies or hanging
    if dims["pp"] > 1:
        raise NotImplementedError(
            f"pp_degree={dims['pp']}: the pipeline over a pp process group "
            "is not ported yet (ROADMAP.md A.6 (e2))")
    if dims["sep"] > 1:
        raise NotImplementedError(
            f"sep_degree={dims['sep']}: sequence and context parallelism "
            "are not ported yet (ROADMAP.md A.6 (e3))")
    if dims["mp"] > 1 and dims["sharding"] > 1:
        raise NotImplementedError(
            f"mp_degree={dims['mp']} beside sharding_degree="
            f"{dims['sharding']}: group sharding of mp-split parameters "
            "is not ported yet (ROADMAP.md A.6 (e5))")
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


def _split_for_mp(model, group):
    """Keep this rank's slice of every parameter that the model's
    partition specs split (module docstring), and hand the mp group to
    every module that runs mp collectives (an ``mp_group`` attribute).
    Returns ``{name: (spec, global shape)}`` of the split parameters."""
    specs = model.partition_specs() \
        if hasattr(model, "partition_specs") else {}
    split = {n: s for n, s in specs.items() if spec_dim(s) is not None}
    # meta-parallel layers are built split: only their group is theirs
    layers = any(isinstance(m, meta_parallel._MPLayer)
                 for m in model.modules())
    if not split and not layers:
        raise ValueError(
            f"mp_degree={group.nranks}: {type(model).__name__} has no "
            "parameter that splits over the mp group (build it with "
            "tensor_parallel=True, or of meta_parallel layers); its ranks "
            "would train unsplit copies")
    check = getattr(model, "check_mp_degree", None)
    if check is not None:
        check(group.nranks)
    out = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in split:
                out[name] = (split[name], tuple(p.shape))
                p.data = spec_piece(p.data, split[name], group.rank,
                                    group.nranks).clone(
                    memory_format=torch.contiguous_format)
    for m in model.modules():
        if hasattr(m, "mp_group") and not isinstance(
                m, meta_parallel._MPLayer):
            m.mp_group = group
    model._mp_split = out
    return out


def distributed_model(model):
    """Split the model over the mp group when mp > 1; then a
    ``DataParallel`` over the dp group when dp > 1, else the model.
    Under sharding stage 3 the model is marked first (its parameters
    rest as regions once ``distributed_optimizer`` shards them)."""
    _require_init()
    hcg = _FLEET["hcg"]
    mp = hcg.get_model_parallel_group()
    if mp is not None:
        _split_for_mp(model, mp)
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
