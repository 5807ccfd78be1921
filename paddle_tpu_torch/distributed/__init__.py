"""The port's distributed stack: the device mesh (``mesh``) and the
hierarchical and int8 collectives (``collectives``) that tensor-parallel
serving runs on; the process-group runtime of a multi-process job (the
TCP store, eager ``communication``, ``init_parallel_env`` and
``DataParallel``, ``launch`` with elastic relaunch, ``elastic``,
``consistency``), the eager bucketed gradient sync
(``collectives.bucketing``, ``fleet.utils``) and its in-graph half
(``BucketedGradSync``); group-sharded training (ZeRO 1/2/3 over the
process group: ``sharding``), fleet's strategy API with its
meta-optimizers and its mp, pp and sep axes (``fleet``: the tensor-parallel
layers of ``fleet.meta_parallel`` and the mp communication of
``fleet.mp_ops`` over fleet's mp process group, ``fleet.utils.
recompute``; ``PipelineLayer`` and the schedules of ``pipeline`` over
fleet's pp process group, their hops tagged p2p over the process
group; the sep axis: ring, Ulysses and megatron attention of
``context_parallel`` over fleet's sep process group, their exchanges
``sep_ops``' autograd functions), and the resharding distributed
checkpoint (``checkpoint``: ``save_state_dict``/``load_state_dict``).
Expert parallelism and the placement API come with the later slices of
``ROADMAP.md`` A.6 ((e4), (e5)).

Deliberate differences from the JAX package: the world's collectives
run on ``torch.distributed`` (gloo or nccl, ``parallel``) where JAX's run
on ``jax.distributed``, so a ring reduction sums in its own order; a
rank's device is its card (``PADDLE_LOCAL_RANK % device_count``);
``torch.distributed`` rendezvous at its own endpoint
(``MASTER_ADDR:MASTER_PORT``) beside the store's ``PADDLE_MASTER``;
``destroy_process_group()`` also closes the store and the process group,
and ``is_initialized()`` says whether ``init_parallel_env`` ran."""
from .communication import (all_reduce, all_gather, all_gather_object,  # noqa
                            reduce_scatter, broadcast, scatter, gather,
                            reduce, alltoall, alltoall_single, send, recv,
                            global_scatter, global_gather, barrier,
                            new_group, get_group, destroy_process_group,
                            wait, stream, ReduceOp, P2POp,
                            batch_isend_irecv, irecv, isend)
from .parallel import (init_parallel_env, get_rank, get_world_size,   # noqa
                       ParallelEnv, DataParallel)
from .launch_utils import spawn                                    # noqa
from ..core.native_api import TCPStore, MasterDaemon               # noqa
from . import launch                                               # noqa
from . import elastic                                              # noqa
from . import consistency                                          # noqa
from .consistency import (program_fingerprint,                     # noqa
                          check_program_consistency)
from . import fleet                                                # noqa
from . import checkpoint                                           # noqa
from . import pipeline                                             # noqa
from . import sharding                                             # noqa
from . import collectives                                          # noqa
from .sharding import (group_sharded_parallel,                     # noqa
                       save_group_sharded_model)
from .checkpoint import save_state_dict, load_state_dict           # noqa
from .fleet import DistributedStrategy as Strategy                 # noqa


def is_initialized() -> bool:
    """Whether ``init_parallel_env`` started this process's group."""
    return ParallelEnv().backend is not None


def get_backend(group=None) -> str:
    """The route ``group``'s collectives take, upper case: ``NCCL`` or
    ``GLOO`` (the world once ``init_parallel_env`` ran), ``STORE`` (subset
    groups, or a job without a process group) or ``LOCAL`` (one process).
    The JAX package answers ``XLA``."""
    from .communication import _route
    return _route(group).upper()
