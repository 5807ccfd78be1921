"""Continuous-batching serving: ``Server`` over the dense engine
(``ContinuousBatchingEngine``) or the paged one (``PagedEngine``,
``ContinuousBatchingEngine(..., paged=True)``)."""
from .engine import (ContinuousBatchingEngine, ModelStepBackend,
                     free_slot_state, init_slot_state, run_decode_block,
                     slot_sample_logits)
from ..graphs import CapturedProgram
from .paging import BlockManager, PagedEngine, PagedModelStepBackend
from .scheduler import Request, Scheduler
from .server import Server

__all__ = ["BlockManager", "CapturedProgram", "ContinuousBatchingEngine",
           "ModelStepBackend", "PagedEngine", "PagedModelStepBackend",
           "Request", "Scheduler", "Server", "free_slot_state",
           "init_slot_state", "run_decode_block", "slot_sample_logits"]
