"""Comms microbenchmark: bytes, algorithmic bandwidth, quant error.

Counterpart of ``paddle_tpu/distributed/collectives/microbench.py``,
over the port's mesh and its host-level collectives (:mod:`.
hierarchical`: stacked per-device contributions in, the global result
out). Each collective runs over the mesh's axes of degree above 1 on a
payload of integer-valued fp32 (so the hierarchical and flat sums are
exact and the measured int8 error is pure quantization), and reports
JAX's keys with JAX's byte accounting:

- ``bytes_moved``: algorithmic wire bytes a device for a ring
  realization (the NCCL-tests accounting): all-reduce ``2*(n-1)/n * S``,
  reduce-scatter and all-gather ``(n-1)/n * S``; the int8 all-reduce is
  charged for the gather-based algorithm it implements;
- ``algbw_gbps``: ``bytes_moved / time``;
- the quantized all-reduce's ``max_error`` against fp32, the
  documented ``error_bound`` it must sit under (``within_bound``), and
  ``constant_exact`` (a constant payload round-trips exactly).

Times are host clock around each call, ending in a device sync on a
CUDA mesh. One controller drives every device of the mesh, so on a mesh
that repeats one card the times are that card's copies and sums, not a
link's."""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["run_comms_bench"]


def _build_mesh():
    """Every visible CUDA device: 2 x n/2 ("dp", "mp") from 4 on, else
    one "mp" axis (JAX's default layout)."""
    from ..mesh import Mesh
    if not torch.cuda.is_available():
        raise RuntimeError("run_comms_bench: no CUDA device is available; "
                           "pass mesh= (e.g. a mesh of [\"cpu\"] * 8)")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devs)
    if n >= 4:
        arr = np.empty(n // 2 * 2, dtype=object)
        arr[:] = devs[:n // 2 * 2]
        return Mesh(arr.reshape(2, n // 2), ("dp", "mp"))
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr, ("mp",))


def _sync(mesh):
    for d in {d for d in mesh.devices.reshape(-1) if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def _timeit(fn, arg, mesh, iters=3):
    fn(arg)                                       # warm
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(arg)
    _sync(mesh)
    return out, (time.perf_counter() - t0) / iters


def run_comms_bench(size_mb: float = 4.0, iters: int = 3,
                    mesh=None) -> dict:
    """Returns a JSON-able dict (JAX's keys): ``devices``, ``axes``,
    ``mode``, ``payload_mb``, then ``all_reduce``, ``reduce_scatter``,
    ``all_gather`` and ``all_reduce_int8`` with ``time_ms``,
    ``bytes_moved`` and ``algbw_gbps`` (the int8 one also
    ``max_error``, ``error_bound``, ``within_bound``,
    ``constant_exact``), and ``quant_vs_fp32_max_error``. ``mesh``: the
    current mesh by default, else every visible CUDA device."""
    from ..mesh import get_current_mesh
    from . import all_gather, all_reduce, collective_config, reduce_scatter
    from .hierarchical import plan_hierarchy
    from .quantized import int8_error_bound

    if mesh is None:
        mesh = get_current_mesh() or _build_mesh()
    axes = tuple(a for a, s in mesh.shape.items() if s > 1) \
        or mesh.axis_names
    plan = plan_hierarchy(axes, mesh)
    n = max(plan.total_size, 1)
    elems = max(int(size_mb * 1e6) // 4 // n * n, n)   # divisible by n
    rs = np.random.RandomState(0)
    data = rs.randint(-64, 64, size=(n, elems)).astype(np.float32)
    x = torch.from_numpy(data)
    size_bytes = elems * 4

    out = {"devices": n, "axes": list(plan.axes), "mode": plan.mode,
           "payload_mb": round(size_bytes / 1e6, 3)}

    def entry(t, bytes_moved):
        return {"time_ms": round(t * 1e3, 3),
                "bytes_moved": int(bytes_moved),
                "algbw_gbps": round(bytes_moved / max(t, 1e-9) / 1e9, 3)}

    ring = (n - 1) / n * size_bytes
    ar, t = _timeit(lambda v: all_reduce(v, axes, mesh, compress=None),
                    x, mesh, iters)
    out["all_reduce"] = entry(t, 2 * ring)
    ref = ar.cpu().numpy()

    _, t = _timeit(lambda v: reduce_scatter(v, axes, mesh), x, mesh, iters)
    out["reduce_scatter"] = entry(t, ring)

    shard = torch.from_numpy(np.ascontiguousarray(data[:, :elems // n]))
    _, t = _timeit(lambda v: all_gather(v, axes, mesh), shard, mesh, iters)
    # per-device shard s: each device receives (n-1)*s of new bytes
    out["all_gather"] = entry(t, (n - 1) * (elems // n) * 4)

    # the quantized A/B, charged for the implemented gather-based
    # algorithm (JAX's accounting): flat (n-1) * S_q; hierarchical
    # (I-1)*S_q + 2*(O-1)/O * S/I + (I-1)*S_q/I, S_q = S*(1+4/bucket)/4
    bucket = collective_config().quant_bucket_size
    qar, t = _timeit(lambda v: all_reduce(v, axes, mesh, compress="int8"),
                     x, mesh, iters)
    q_per = (1.0 + 4.0 / bucket) / 4.0
    if plan.flat:
        qbytes = (n - 1) * size_bytes * q_per
    else:
        inner = plan.inner_size
        outer = n // inner
        qbytes = ((inner - 1) * size_bytes * q_per
                  + 2 * (outer - 1) / outer * (size_bytes / inner)
                  + (inner - 1) * size_bytes * q_per / inner)
    q = entry(t, qbytes)
    err = float(np.max(np.abs(qar.cpu().numpy() - ref)))
    bound = float(int8_error_bound(float(np.abs(data).max()), n,
                                   bucket_absmax_out=float(
                                       np.abs(ref).max())))
    q["max_error"] = err
    q["error_bound"] = bound
    q["within_bound"] = bool(err <= bound)
    const = torch.full((n, 4 * bucket), 3.25, dtype=torch.float32)
    qc = all_reduce(const, axes, mesh, compress="int8").cpu().numpy()
    q["constant_exact"] = bool(np.all(qc == 3.25 * n))
    out["all_reduce_int8"] = q
    out["quant_vs_fp32_max_error"] = err
    return out
