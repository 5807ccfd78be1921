"""A program over static tensors: one CUDA graph on the card, the same
Python function run eagerly on the CPU.

Counterpart of ``jax.jit`` around the JAX engine's two programs
(``paddle_tpu/serving/engine.py`` ``build_slot_block_fn`` and
``build_paged_chunk_fn``) and around the JAX training and evaluation
steps (``paddle_tpu/jit/__init__.py`` ``TrainStep``, ``EvalStep``; the
port's ``jit.py``): JAX traces each once per shape and then runs the
compiled program; here :meth:`CapturedProgram.capture`
runs the function once on a side stream (the warm-up: every buffer a
wrapper makes lazily, such as the megakernel's scratch, its tickets and
the occupancy caches, exists before capture, outside the graph's memory
pool), once under stream capture, and from then on each call replays
the graph. The function reads and writes only tensors that outlive the
graph: the model's weights, the arena and the engine's state and static
buffers. There is no switch that turns capture off, and a capture that
fails raises.

Kernel wrappers count their launches in Python, which runs only while
the graph is captured. So the program records each count's change
during capture, takes back what the warm-up and the capture added
(they serve no request) and adds that change at every replay: the
counts stay the launches of served work, as in an eager run."""
from __future__ import annotations

import time

import torch

from . import ops
from .ops.paged_attention import ticket_buffers

__all__ = ["CapturedProgram"]

# (device, shared pool) -> the stream its programs capture on
_CAPTURE_STREAMS = {}


class CapturedProgram:
    """``fn`` (no arguments, no result: it works on static tensors) as
    one program on ``device``. On a CUDA device :meth:`capture` makes
    the graph and each call replays it; on the CPU nothing is captured
    and each call runs ``fn``. ``captures`` counts the captures (the
    JAX engine's trace counter: 1 once captured, 0 on the CPU);
    ``capture_s`` is the wall time of the warm-up and the capture and
    ``graph_bytes`` the device memory the capture added to the graph's
    pool. The graph, its pool and the shared buffers it launches
    on belong to the program and are freed with it. Programs given one
    ``pool`` (``torch.cuda.graph_pool_handle()``) capture into the same
    memory pool: only programs that never run concurrently and whose
    allocations all die within a run (their results land in static
    tensors) may share one, and they may then replay in any order.
    ``name`` names the program in a failed capture's error."""

    def __init__(self, fn, device, pool=None, name="the program"):
        self._fn = fn
        self.name = name
        self.device = torch.device(device)
        self.pool = pool
        self.graph = None
        self.captures = 0
        self.capture_s = 0.0
        self.graph_bytes = 0
        self._launches = {}
        self.warmup_launches = {}
        self._held = ()

    def capture(self):
        """Warm up, then capture ``fn`` into a CUDA graph (CPU: no-op).
        The warm-up runs ``fn`` for real, so the caller runs it over a
        state it can restore."""
        if self.device.type != "cuda":
            return
        t0 = time.perf_counter()
        counts = ops.launch_counts()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._fn()
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        warm = ops.launch_counts()
        self.warmup_launches = {k: warm[k] - counts[k] for k in warm
                                if warm[k] != counts[k]}
        # the pool's bytes are what the capture reserves beyond an empty
        # cache (torch.cuda.graph empties the cache before it captures)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        stream = self._capture_stream()
        try:
            # entered here as well: a capture that fails leaves
            # torch.cuda.graph's stream current, and this restores ours
            with torch.cuda.device(self.device), torch.cuda.stream(stream), \
                    torch.cuda.graph(graph, pool=self.pool, stream=stream):
                self._fn()
        except RuntimeError as e:
            # the failed capture leaves the caching allocator routing the
            # stream's allocations to its pool: no capture uses it again
            _CAPTURE_STREAMS.pop((self.device, self.pool), None)
            cause = f"{e}" + (f" (after: {e.__context__})"
                              if e.__context__ is not None else "")
            raise RuntimeError(
                f"capturing {self.name} as a CUDA graph failed: {cause}. "
                "A captured program runs on the device alone: it may not "
                "read a device value on the host (.item(), float(), "
                ".tolist(), .cpu(), print, a data-dependent shape) or copy "
                "from host memory (torch.tensor(..., device=...)); a "
                "backward may not meet an autograd graph over the same "
                "parameters that an eager run on another stream left alive "
                "(a loss tensor kept from it: drop it first)") from e
        torch.cuda.synchronize(self.device)
        self.graph_bytes = torch.cuda.memory_reserved(self.device) - reserved
        after = ops.launch_counts()
        self._launches = {k: after[k] - warm[k] for k in after
                          if after[k] != warm[k]}
        ops.add_launch_counts({k: counts[k] - after[k] for k in after})
        self.graph = graph
        # buffers shared across calls that the graph launches on: a
        # later, larger call may replace them in their module's cache
        self._held = ticket_buffers()
        # the graph replays without the function; dropping it here keeps
        # the owner free of a reference cycle through a bound method
        self._fn = None
        self.captures += 1
        self.capture_s = time.perf_counter() - t0

    def _capture_stream(self):
        """The stream to capture on: one per shared pool, since the
        caching allocator keeps a pool's blocks per stream and programs
        sharing a pool reuse each other's memory only on one stream; a
        program with a pool of its own gets a stream of its own."""
        if self.pool is None:
            return torch.cuda.Stream(self.device)
        key = (self.device, self.pool)
        if key not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[key] = torch.cuda.Stream(self.device)
        return _CAPTURE_STREAMS[key]

    def __call__(self):
        if self.graph is None:
            self._fn()
            return
        self.graph.replay()
        ops.add_launch_counts(self._launches)
