"""Distributed helpers of the port. Only the checkpoint module's atomic
file writes are ported so far (the serving snapshots and the flight
recorder need them); the rest of ``paddle_tpu/distributed`` comes with
``ROADMAP.md`` A.6."""
