"""Elastic membership over the job's store.

Counterpart of ``paddle_tpu/distributed/elastic.py`` (the reference's
etcd-backed elastic manager, with the TCP store as the registry): nodes
register and heartbeat ``elastic/hb/<node>`` counters; a node counts as
alive while its counter advances by this manager's own clock (so clock
skew between hosts cannot fake a death). When the count of live nodes
changes within ``[min_np, max_np]`` the generation is bumped, and every
watcher returns ``RESTART``: the launcher relaunches the workers, which
resume from their latest checkpoint."""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from ..core.native_api import TCPStore

__all__ = ["ElasticManager", "ElasticStatus"]


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    """Node-membership tracker over a TCPStore.

    Each node heartbeats ``elastic/node/{id}`` with a timestamp; the
    manager counts nodes with fresh heartbeats. When the count changes
    while min_np <= count <= max_np, the generation key is bumped: all
    nodes observe it and return RESTART from watch().
    """

    def __init__(self, host: str, port: int, node_id: Optional[str] = None,
                 min_np: int = 1, max_np: int = 0,
                 heartbeat_interval: float = 1.0,
                 heartbeat_timeout: float = 5.0):
        self.node_id = node_id or f"{os.uname().nodename}-{os.getpid()}"
        self.min_np = min_np
        self.max_np = max_np or (1 << 30)
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self._store = TCPStore(host, port)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_count = 0
        # node -> (last seen heartbeat counter, local monotonic time it
        # changed). Liveness = counter advanced recently BY OUR CLOCK, so
        # cross-host wall-clock skew cannot fake a death.
        self._hb_seen: dict = {}

    # -- membership ---------------------------------------------------------

    def register(self):
        """Join the cluster and start heartbeating. Membership updates go
        through the store's atomic add (slot counter + per-slot key), so
        concurrent joins cannot lose each other."""
        slot = self._store.add("elastic/nslots", 1)
        self._store.set(f"elastic/member/{slot}", self.node_id)
        # a relaunched node reuses its node_id: clear any tombstone from
        # the previous generation or it stays excluded forever
        self._store.delete_key(f"elastic/left/{self.node_id}")
        self._beat()
        self._thread = threading.Thread(target=self._heartbeat_loop,
                                        daemon=True)
        self._thread.start()
        self._last_count = len(self.alive_nodes())

    def deregister(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self._store.set(f"elastic/left/{self.node_id}", "1")

    def _known_nodes(self):
        if not self._store.check("elastic/nslots"):
            return []
        n = self._store.add("elastic/nslots", 0)
        nodes = []
        for slot in range(1, n + 1):
            key = f"elastic/member/{slot}"
            if not self._store.check(key):
                continue
            node = self._store.get(key).decode()
            if node and not self._store.check(f"elastic/left/{node}") \
                    and node not in nodes:
                nodes.append(node)
        return nodes

    def _beat(self):
        self._store.add(f"elastic/hb/{self.node_id}", 1)

    def _heartbeat_loop(self):
        while not self._stop.wait(self.heartbeat_interval):
            try:
                self._beat()
            except ConnectionError:
                return

    def alive_nodes(self):
        now = time.monotonic()
        alive = []
        for n in self._known_nodes():
            key = f"elastic/hb/{n}"
            if not self._store.check(key):
                continue
            counter = self._store.add(key, 0)
            seen = self._hb_seen.get(n)
            if seen is None or counter != seen[0]:
                self._hb_seen[n] = (counter, now)
                alive.append(n)
            elif now - seen[1] <= self.heartbeat_timeout:
                alive.append(n)
        return alive

    # -- scale watch --------------------------------------------------------

    @property
    def generation(self) -> int:
        if not self._store.check("elastic/generation"):
            return 0
        return int(self._store.get("elastic/generation").decode())

    def _bump_generation(self):
        gen = self._store.add("elastic/generation_counter", 1)
        self._store.set("elastic/generation", str(gen))
        return gen

    def watch(self, poll: float = 0.5,
              should_stop: Optional[Callable[[], bool]] = None) -> str:
        """Block until a scale event / completion; returns ElasticStatus."""
        seen_gen = self.generation
        while True:
            if should_stop is not None and should_stop():
                return ElasticStatus.COMPLETED
            count = len(self.alive_nodes())
            if count != self._last_count:
                if count < self.min_np:
                    # below quorum: hold until nodes return or exceed
                    self._last_count = count
                    if count == 0:
                        return ElasticStatus.ERROR
                    # stay in HOLD by continuing the loop
                elif count <= self.max_np:
                    self._last_count = count
                    self._bump_generation()
                    return ElasticStatus.RESTART
            if self.generation != seen_gen:
                return ElasticStatus.RESTART
            time.sleep(poll)

    def close(self):
        try:
            self.deregister()
        finally:
            self._store.close()
