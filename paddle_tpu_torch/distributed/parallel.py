"""The process group of a job, and ``DataParallel``.

Counterpart of ``paddle_tpu/distributed/parallel.py``. In the JAX package
``init_parallel_env`` is ``jax.distributed.initialize`` and data
parallelism is SPMD inside one jitted step. The port starts
``torch.distributed`` instead, from the launch contract
(``launch_utils.worker_env``): rank ``PADDLE_TRAINER_ID`` of
``PADDLE_TRAINERS_NUM``, its rendezvous at ``MASTER_ADDR:MASTER_PORT``
(a second endpoint beside the store's ``PADDLE_MASTER``).

A rank's device is the card ``PADDLE_LOCAL_RANK % device_count`` unless
``init_parallel_env(device=...)`` names one (``device="cpu"`` for a job
on the host; without a card and without it, it raises). In JAX a
process owns a whole TPU host and ``device_id`` is 0. The backend
follows from where the ranks are: ``nccl`` when each rank of the node
has a card of its own, ``gloo`` when ranks share a card (NCCL refuses
two ranks on one GPU) or run on the host. The gloo route stages CUDA
tensors through host memory (``communication``).

Gloo moves each collective over one TCP connection, about 1 GB/s on
loopback. When every rank of the job runs on this host and the job sets
no ``GLOO_SOCKET_IFNAME``, ``init_parallel_env`` gives gloo
``GLOO_LOOPBACK_DEVICES`` loopback devices (``lo`` repeated), and the
bucketed syncs keep several buckets in flight, one a device.

``DataParallel`` keeps paddle's manual loop (forward, ``backward()``,
``sync_gradients()`` or ``fleet.utils.fused_allreduce_gradients``,
``opt.step()``): the eager sync is a bucketed mean all-reduce of the
gradients over the world's route. A step captured as one CUDA graph
cannot hold a gloo or store collective, so the data-parallel step is
eager."""
from __future__ import annotations

import contextlib
import os
import socket
from typing import Optional

import torch

from ..utils.flags import env_int, env_str
from . import communication as C
from .launch_utils import find_free_port

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "ParallelEnv", "DataParallel"]

_STATE = {"device": None, "backend": None}
GLOO_LOOPBACK_DEVICES = 4


@contextlib.contextmanager
def _gloo_loopback(n: int, local_size: int):
    """Several loopback devices for a gloo group whose ranks all run on
    this host (module docstring), set only while the group is made (gloo
    reads ``GLOO_SOCKET_IFNAME`` there); a job's own value stands."""
    if local_size < n or "GLOO_SOCKET_IFNAME" in os.environ or \
            "lo" not in {name for _, name in socket.if_nameindex()}:
        yield
        return
    os.environ["GLOO_SOCKET_IFNAME"] = ",".join(
        ["lo"] * GLOO_LOOPBACK_DEVICES)
    try:
        yield
    finally:
        os.environ.pop("GLOO_SOCKET_IFNAME", None)


def _shutdown():
    """Destroy the process group ``init_parallel_env`` started."""
    if _STATE["backend"] is not None and C._pg_up():
        torch.distributed.destroy_process_group()
    _STATE.update(device=None, backend=None)


def init_parallel_env(device=None):
    """Start ``torch.distributed`` for this rank (module docstring) and
    make its device the current CUDA device. A second call returns the
    environment of the first."""
    if _STATE["backend"] is not None:
        return ParallelEnv()
    n = env_int("PADDLE_TRAINERS_NUM", 1)
    rank = env_int("PADDLE_TRAINER_ID", 0)
    local_rank = env_int("PADDLE_LOCAL_RANK", rank)
    local_size = env_int("PADDLE_LOCAL_SIZE", n)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_parallel_env: no CUDA device is available; pass "
                "device=\"cpu\" for a job on the host")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda",
                               local_rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        own_card = local_size <= torch.cuda.device_count()
        backend = "nccl" if own_card else "gloo"
    else:
        backend = "gloo"
    addr = env_str("MASTER_ADDR", "")
    port = env_str("MASTER_PORT", "")
    if not (addr and port):
        if n > 1:
            raise RuntimeError(
                "init_parallel_env: a job of several ranks needs the "
                "torch.distributed rendezvous MASTER_ADDR and MASTER_PORT "
                "(python -m paddle_tpu_torch.distributed.launch sets them)")
        addr, port = "127.0.0.1", str(find_free_port())
    kw = {"device_id": dev} if backend == "nccl" else {}
    with _gloo_loopback(n, local_size) if backend == "gloo" \
            else contextlib.nullcontext():
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://{addr}:{port}", rank=rank,
            world_size=n, **kw)
    _STATE.update(device=dev, backend=backend)
    return ParallelEnv()


def get_rank(group=None):
    """This process's rank: the launch contract's first, else the process
    group's, else 0 (in ``group``: its index there, -1 outside it)."""
    if group is not None:
        return group.get_group_rank(C._my_rank())
    return C._my_rank()


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    return C._world_size()


class ParallelEnv:
    @property
    def rank(self):
        return C._my_rank()

    @property
    def local_rank(self):
        return env_int("PADDLE_LOCAL_RANK", self.rank)

    @property
    def world_size(self):
        return C._world_size()

    @property
    def nranks(self):
        return self.world_size

    @property
    def device(self) -> Optional[torch.device]:
        """The device ``init_parallel_env`` chose (None before it)."""
        return _STATE["device"]

    @property
    def backend(self) -> Optional[str]:
        return _STATE["backend"]

    @property
    def device_id(self):
        """The index of this rank's card (0 on the host)."""
        dev = _STATE["device"]
        if dev is not None:
            return dev.index or 0
        if torch.cuda.is_available():
            return self.local_rank % torch.cuda.device_count()
        return 0

    @property
    def dev_id(self):
        return self.device_id

    @property
    def current_endpoint(self):
        return env_str("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        eps = env_str("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []


class DataParallel(torch.nn.Module):
    """Marks a model data-parallel. The forward is the model's; between
    ``backward()`` and ``opt.step()`` a manual loop calls
    :meth:`sync_gradients` (a no-op inside :meth:`no_sync`), a bucketed
    mean all-reduce of the gradients sized by ``comm_buffer_size`` (MB),
    as the reference's Reducer; it leaves out the parameters of a
    group-sharded optimizer, whose step reduces them (``sharding``).
    ``state_dict`` is the model's."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._comm_buffer_bytes = int(comm_buffer_size) << 20
        self._dp_group = group
        self._no_sync = False

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def sync_gradients(self, parameters=None):
        """Mean all-reduce of every gradient over the data-parallel
        group, bucket by bucket (``collectives.bucketing``)."""
        if self._no_sync:
            return
        from .collectives import bucketed_allreduce_gradients
        params = list(parameters if parameters is not None
                      else self._layers.parameters())
        bucketed_allreduce_gradients(
            params, group=self._dp_group,
            bucket_bytes=self._comm_buffer_bytes)

    @contextlib.contextmanager
    def no_sync(self):
        prev, self._no_sync = self._no_sync, True
        try:
            yield
        finally:
            self._no_sync = prev

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, state_dict, *a, **k):
        return self._layers.load_state_dict(state_dict, *a, **k)

    set_state_dict = load_state_dict
