"""Free ports, the worker environment contract, and process spawn.

Counterpart of ``paddle_tpu/distributed/launch_utils.py``. A job's
workers learn who they are from the environment that ``launch`` and
:func:`spawn` set (:func:`worker_env`):

- the JAX package's contract: ``PADDLE_TRAINER_ID`` (the global rank),
  ``PADDLE_TRAINERS_NUM`` (the world size), ``PADDLE_MASTER`` (the
  ``host:port`` where rank 0 hosts the TCP store), ``PADDLE_LOCAL_RANK``
  and ``PADDLE_RESTART_COUNT``, plus ``PADDLE_LOCAL_SIZE`` (the ranks
  on this node);
- beside it, ``torch.distributed``'s: ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR``/
  ``MASTER_PORT``, the rendezvous of ``init_parallel_env``'s process
  group. It is a second endpoint: the store's server and
  ``torch.distributed``'s own store never share a port.

The JAX package sets ``JAX_COORDINATOR_ADDRESS``, ``JAX_PROCESS_ID`` and
``JAX_NUM_PROCESSES`` instead of the torch variables."""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
from typing import Callable

__all__ = ["spawn", "find_free_port", "free_ports", "worker_env"]


def find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def free_ports(n: int) -> list:
    """``n`` distinct free ports of this host."""
    ports = []
    while len(ports) < n:
        port = find_free_port()
        if port not in ports:
            ports.append(port)
    return ports


def worker_env(rank: int, world_size: int, master: str, rendezvous: str,
               local_rank: int, local_size: int,
               restart: int = 0) -> dict:
    """The variables a worker of rank ``rank`` gets (module docstring):
    ``master`` is the store's ``host:port``, ``rendezvous`` that of
    ``torch.distributed``."""
    addr, port = rendezvous.rsplit(":", 1)
    return {
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world_size),
        "PADDLE_MASTER": master,
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_LOCAL_SIZE": str(local_size),
        "PADDLE_RESTART_COUNT": str(restart),
        "RANK": str(rank),
        "WORLD_SIZE": str(world_size),
        "LOCAL_RANK": str(local_rank),
        "LOCAL_WORLD_SIZE": str(local_size),
        "MASTER_ADDR": addr,
        "MASTER_PORT": port,
    }


def _worker(fn, rank, nprocs, master, rendezvous, args):
    os.environ.update(worker_env(rank, nprocs, master, rendezvous, rank,
                                 nprocs))
    fn(*args)


def spawn(func: Callable, args=(), nprocs: int = 1, join: bool = True,
          daemon: bool = False, **options):
    """Run ``func(*args)`` in ``nprocs`` fresh processes (the ``spawn``
    start method) on this host, each with the environment of one rank;
    ``join`` waits for them and raises if one exits non-zero. Returns
    the processes."""
    ctx = mp.get_context("spawn")
    master, rendezvous = (f"127.0.0.1:{p}" for p in free_ports(2))
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(func, rank, nprocs, master, rendezvous, args),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        for p in procs:
            if p.exitcode != 0:
                raise RuntimeError(
                    f"spawned process exited with code {p.exitcode}")
    return procs
