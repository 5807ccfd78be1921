"""The job launcher: ``python -m paddle_tpu_torch.distributed.launch``.

Counterpart of ``paddle_tpu/distributed/launch``: starts
``--nproc_per_node`` worker processes of a script on this node, each
with the environment of its rank (``launch_utils.worker_env``: the
``PADDLE_*`` contract and ``torch.distributed``'s variables beside it),
watches them, and on a worker's failure kills the pod and relaunches it
while restarts remain (``--max_restarts``); the workers resume from
their own checkpoints, as in the reference's elastic recovery. Each
worker's output goes to ``<log_dir>/workerlog.<rank>.r<restart>``.

Two endpoints: ``--master`` is the store's (rank 0 hosts it), and
``torch.distributed``'s rendezvous is ``--rendezvous``; given a master
and no rendezvous, the rendezvous is the master's host at the next port
(every node computes the same one); given neither, both are free ports
of this host. One process a card is the CUDA norm, unlike JAX's one
process a TPU host, but ``--nproc_per_node`` still defaults to 1 and
``--devices`` is accepted and ignored, as in JAX: a worker's card is
``PADDLE_LOCAL_RANK % device_count`` (``init_parallel_env``)."""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

from ..launch_utils import free_ports, worker_env
from ...utils.flags import env_int

__all__ = ["LaunchConfig", "launch_pod", "main"]


class LaunchConfig:
    def __init__(self, script: str, script_args=(), nnodes: int = 1,
                 node_rank: int = 0, nproc_per_node: int = 1,
                 master: Optional[str] = None,
                 rendezvous: Optional[str] = None, log_dir: str = "log",
                 max_restarts: int = 0, envs: Optional[dict] = None):
        self.script = script
        self.script_args = list(script_args)
        self.nnodes = nnodes
        self.node_rank = node_rank
        self.nproc_per_node = nproc_per_node
        if master is None:
            ports = free_ports(2)
            master = f"127.0.0.1:{ports[0]}"
            rendezvous = rendezvous or f"127.0.0.1:{ports[1]}"
        elif rendezvous is None:
            host, port = master.rsplit(":", 1)
            rendezvous = f"{host}:{int(port) + 1}"
        self.master = master
        self.rendezvous = rendezvous
        self.log_dir = log_dir
        self.max_restarts = max_restarts
        self.envs = envs or {}

    @property
    def world_size(self):
        return self.nnodes * self.nproc_per_node


def _worker_env(cfg: LaunchConfig, local_rank: int, restart: int) -> dict:
    rank = cfg.node_rank * cfg.nproc_per_node + local_rank
    env = dict(os.environ)
    env.update(cfg.envs)
    env.update(worker_env(rank, cfg.world_size, cfg.master, cfg.rendezvous,
                          local_rank, cfg.nproc_per_node, restart))
    return env


def _spawn_pod(cfg: LaunchConfig, restart: int) -> List[subprocess.Popen]:
    os.makedirs(cfg.log_dir, exist_ok=True)
    procs = []
    for lr in range(cfg.nproc_per_node):
        rank = cfg.node_rank * cfg.nproc_per_node + lr
        log = open(os.path.join(cfg.log_dir,
                                f"workerlog.{rank}.r{restart}"), "w")
        cmd = [sys.executable, "-u", cfg.script] + cfg.script_args
        p = subprocess.Popen(cmd, env=_worker_env(cfg, lr, restart),
                             stdout=log, stderr=subprocess.STDOUT)
        p._pt_log = log  # closed with the pod
        procs.append(p)
    return procs


def _kill_pod(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + 10
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    for p in procs:
        p._pt_log.close()


def launch_pod(cfg: LaunchConfig) -> int:
    """Spawn the local pod and watch it. On a worker's failure: kill the
    pod and, while restarts remain, relaunch it; else return the failing
    exit code (0 when every worker succeeds)."""
    restart = 0
    while True:
        procs = _spawn_pod(cfg, restart)
        failed_code = None
        try:
            while True:
                alive = 0
                for p in procs:
                    code = p.poll()
                    if code is None:
                        alive += 1
                    elif code != 0 and failed_code is None:
                        failed_code = code
                if failed_code is not None or alive == 0:
                    break
                time.sleep(0.2)
        finally:
            if failed_code is not None or any(p.poll() is None
                                               for p in procs):
                _kill_pod(procs)
            else:
                for p in procs:
                    p._pt_log.close()
        if failed_code is None:
            return 0
        if restart >= cfg.max_restarts:
            print(f"[launch] worker failed with exit code {failed_code}; "
                  f"no restarts left", file=sys.stderr)
            return failed_code
        restart += 1
        print(f"[launch] worker failed (exit {failed_code}); relaunching "
              f"pod (restart {restart}/{cfg.max_restarts})",
              file=sys.stderr)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="launch distributed training (one process a card)")
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--node_rank", type=int,
                        default=env_int("PADDLE_NODE_RANK", 0))
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--master", type=str, default=None,
                        help="host:port of the rank-0 rendezvous store")
    parser.add_argument("--rendezvous", type=str, default=None,
                        help="host:port of torch.distributed's rendezvous "
                        "(default: the master's host, its port + 1)")
    parser.add_argument("--log_dir", type=str, default="log")
    parser.add_argument("--max_restarts", type=int, default=0,
                        help=">0 enables elastic relaunch-on-failure")
    parser.add_argument("--devices", type=str, default=None,
                        help="accepted for reference-CLI compatibility and "
                        "ignored: a worker's card follows its local rank")
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = LaunchConfig(
        script=args.script, script_args=args.script_args,
        nnodes=args.nnodes, node_rank=args.node_rank,
        nproc_per_node=args.nproc_per_node, master=args.master,
        rendezvous=args.rendezvous, log_dir=args.log_dir,
        max_restarts=args.max_restarts)
    return launch_pod(cfg)
