"""Distributed helpers of the port: the device mesh (``mesh``) and the
hierarchical and int8 collectives (``collectives``) that tensor-parallel
serving runs on, and the checkpoint module's atomic file writes (the
serving snapshots and the flight recorder need them). The process-group
runtime, data parallelism, the sharded checkpoint and pipeline, sequence
and expert parallelism come with the later slices of ``ROADMAP.md``
A.6."""
