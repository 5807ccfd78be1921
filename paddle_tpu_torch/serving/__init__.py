"""Continuous-batching serving: ``Server`` over the dense engine
(``ContinuousBatchingEngine``) or the paged one (``PagedEngine``,
``ContinuousBatchingEngine(..., paged=True)``), with the resilience
policies of ``resilience`` (deadlines, shedding, retry and breaker, the
NaN quarantine, crash-safe snapshots), the decode features of ``quant``
(weight-only int8/int4) and ``spec`` (speculative decoding), and the
multi-tenant front door of ``frontend`` (streams, weighted-fair
queueing, priority preemption), and the disaggregated serving fleet of
``fleet`` (prefill and decode workers, the KV handoff wire format of
``handoff`` over the transports of ``transport``, prefix-affinity
routing, the fleet-wide prefix cache of ``prefix_cache``, failure
redrive) with the open-loop load generator of ``loadgen``, its durable
control plane of ``durability`` (write-ahead journal, checkpoint
manifests, the disk prefix spill, whole-fleet recovery) and the SLO
autoscaler of ``autoscaler``; and tensor-parallel serving over a mesh
(``tp``: ``TPConfig``, the sharded backends)."""
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
from .fleet import (DecodeWorker, Fleet, FleetRouter, PrefillDenseEngine,
                    PrefillPagedEngine, PrefillWorker)
from .handoff import (KVHandoff, decode_handoff, encode_handoff,
                      reshard_kv_chunks)
from .loadgen import Trace, TraceConfig, generate_trace, replay
from .durability import PrefixSpillStore, WriteAheadJournal
from .autoscaler import (Autoscaler, AutoscalerConfig, DecisionKernel,
                         Observation)
from .prefix_cache import (PrefixCacheDirectory, adopt_prefix,
                           extract_prefix)
from .transport import (InProcessTransport, SocketTransport, Transport,
                        TransportError)
from .tp import (ShardedModelStepBackend, ShardedPagedStepBackend,
                 TPConfig)

__all__ = ["Autoscaler", "AutoscalerConfig", "BlockManager", "CapturedProgram",
           "ContinuousBatchingEngine", "DecisionKernel", "DecodeWorker",
           "FairScheduler", "Fleet", "FleetRouter", "Frontend",
           "InProcessTransport", "KVHandoff", "ModelStepBackend",
           "Observation", "PagedEngine", "PagedModelStepBackend",
           "PrefillDenseEngine", "PrefillPagedEngine", "PrefillWorker",
           "PrefixCacheDirectory", "PrefixSpillStore", "QuantConfig",
           "Request", "RequestFailure", "ResilienceConfig", "ResumeState",
           "Scheduler", "Server", "SocketTransport", "SpecConfig",
           "SpecEngine", "SpecModelStepBackend", "SpecPagedEngine",
           "ShardedModelStepBackend", "ShardedPagedStepBackend",
           "SpecPagedStepBackend", "TPConfig", "TenantConfig",
           "TokenStream", "Trace",
           "TraceConfig", "Transport", "TransportError", "WeightOnlyLinear",
           "WriteAheadJournal", "adopt_prefix", "decode_handoff",
           "encode_handoff", "extract_prefix", "free_slot_state",
           "generate_trace", "init_slot_state", "ngram_propose", "replay",
           "reshard_kv_chunks", "run_decode_block", "slot_sample_logits"]
