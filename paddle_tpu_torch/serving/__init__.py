"""Continuous-batching serving: ``Server`` over the dense engine
(``ContinuousBatchingEngine``) or the paged one (``PagedEngine``,
``ContinuousBatchingEngine(..., paged=True)``), with the resilience
policies of ``resilience`` (deadlines, shedding, retry and breaker, the
NaN quarantine, crash-safe snapshots), the decode features of ``quant``
(weight-only int8/int4) and ``spec`` (speculative decoding), and the
multi-tenant front door of ``frontend`` (streams, weighted-fair
queueing, priority preemption)."""
from .engine import (ContinuousBatchingEngine, ModelStepBackend,
                     free_slot_state, init_slot_state, run_decode_block,
                     slot_sample_logits)
from ..graphs import CapturedProgram
from .paging import BlockManager, PagedEngine, PagedModelStepBackend
from .quant import QuantConfig, WeightOnlyLinear
from .resilience import RequestFailure, ResilienceConfig
from .scheduler import Request, ResumeState, Scheduler
from .server import Server
from .spec import (SpecConfig, SpecEngine, SpecModelStepBackend,
                   SpecPagedEngine, SpecPagedStepBackend, ngram_propose)
from .frontend import FairScheduler, Frontend, TenantConfig, TokenStream

__all__ = ["BlockManager", "CapturedProgram", "ContinuousBatchingEngine",
           "FairScheduler", "Frontend", "ModelStepBackend", "PagedEngine",
           "PagedModelStepBackend", "QuantConfig", "Request",
           "RequestFailure", "ResilienceConfig", "ResumeState", "Scheduler",
           "Server", "SpecConfig", "SpecEngine", "SpecModelStepBackend",
           "SpecPagedEngine", "SpecPagedStepBackend", "TenantConfig",
           "TokenStream", "WeightOnlyLinear", "free_slot_state",
           "init_slot_state", "ngram_propose", "run_decode_block",
           "slot_sample_logits"]
