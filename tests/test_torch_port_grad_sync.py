"""The port's in-graph gradient bucketer and comms microbench against the
JAX package, on the CPU.

The cases of ``tests/test_collectives.py`` for ``BucketedGradSync``,
``attach_grad_sync`` and ``run_comms_bench``. JAX syncs inside
``shard_map`` over a 2x4 mesh of its 8 simulated devices; the port's
counterpart of a bound ``shard_map`` is the per-shard list over a 2x4
mesh of ``["cpu"] * 8``, and a plain dict is the unbound case. The same
integer-valued data go through both, so every sum is exact and the
comparisons are bit for bit (the int8 error against its bound)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from paddle_tpu.distributed import collectives as jcc
from paddle_tpu.distributed.mesh import build_device_mesh as jax_mesh

from paddle_tpu_torch.distributed import collectives as cc
from paddle_tpu_torch.distributed.collectives import (
    BucketedGradSync, attach_grad_sync, bucketed_allreduce_gradients,
    configure, run_comms_bench)
from paddle_tpu_torch.distributed.mesh import build_device_mesh
from paddle_tpu_torch.optimizer import AdamW

SHAPES = {"w1": (4, 8), "b1": (8,), "w2": (8, 3), "b2": (3,)}


@pytest.fixture(scope="module")
def meshes():
    return (jax_mesh({"dp": 2, "mp": 4}),
            build_device_mesh({"dp": 2, "mp": 4}, devices=["cpu"] * 8))


def _idata(rs, shape, lo=-32, hi=32):
    return rs.randint(lo, hi, size=shape).astype(np.float32)


def _jax_sync(mesh, stacked, hook_kw, mesh_for_hook=True):
    """JAX's hook inside shard_map over "dp": (synced, pmean) per key."""
    hook = jcc.BucketedGradSync(axes=("dp",),
                                mesh=mesh if mesh_for_hook else None,
                                **hook_kw)

    def inner(gs):
        local = {k: jnp.squeeze(v, 0) for k, v in gs.items()}
        return hook(local), {k: jax.lax.pmean(v, "dp")
                             for k, v in local.items()}
    specs = {k: P("dp") for k in stacked}
    synced, ref = shard_map(
        inner, mesh=mesh, in_specs=(specs,),
        out_specs=({k: P() for k in stacked}, {k: P() for k in stacked}),
        check_rep=False)({k: jnp.asarray(v) for k, v in stacked.items()})
    return ({k: np.asarray(v) for k, v in synced.items()},
            {k: np.asarray(v) for k, v in ref.items()})


def _shards(stacked):
    return [{k: torch.from_numpy(v[s].copy()) for k, v in stacked.items()}
            for s in range(2)]


@pytest.mark.parametrize("bucket_bytes", [64, 1 << 20])
def test_hook_preserves_values_as_jax(meshes, bucket_bytes):
    jm, tm = meshes
    rs = np.random.RandomState(5)
    stacked = {k: _idata(rs, (2,) + s) for k, s in SHAPES.items()}
    want, ref = _jax_sync(jm, stacked, {"bucket_bytes": bucket_bytes,
                                        "compress": None})
    hook = BucketedGradSync(axes=("dp",), bucket_bytes=bucket_bytes,
                            compress=None, mesh=tm)
    got = hook(_shards(stacked))
    for s in range(2):
        for k in SHAPES:
            assert got[s][k].shape == SHAPES[k]
            np.testing.assert_array_equal(got[s][k].numpy(), want[k])
            np.testing.assert_array_equal(got[s][k].numpy(), ref[k])


def test_hook_means_without_a_registered_mesh(meshes):
    jm, _ = meshes
    x = np.asarray([[2.0, 4.0], [6.0, 8.0]], np.float32)
    want, _ = _jax_sync(jm, {"w": x}, {}, mesh_for_hook=False)
    got = BucketedGradSync(axes=("dp",), mesh=None)(
        [{"w": torch.from_numpy(x[0].copy())},
         {"w": torch.from_numpy(x[1].copy())}])
    np.testing.assert_array_equal(want["w"], [4.0, 6.0])
    for s in range(2):
        np.testing.assert_array_equal(got[s]["w"].numpy(), want["w"])


def test_zero_size_gradients_pass_through(meshes):
    _, tm = meshes
    hook = BucketedGradSync(axes=("dp",), bucket_bytes=1 << 10, mesh=tm)
    shards = [{"empty": torch.zeros(0, 3), "w": torch.tensor([1.0, 3.0])},
              {"empty": torch.zeros(0, 3), "w": torch.tensor([5.0, 7.0])}]
    got = hook(shards)
    for s in range(2):
        assert got[s]["empty"].shape == (0, 3)
        assert got[s]["empty"] is shards[s]["empty"]
        np.testing.assert_array_equal(got[s]["w"].numpy(), [3.0, 5.0])
    p1 = torch.zeros(0, 3, requires_grad=True)
    p1.grad = torch.zeros(0, 3)
    p2 = torch.ones(2, 2, requires_grad=True)
    p2.grad = torch.full((2, 2), 4.0)
    bucketed_allreduce_gradients([p1, p2], bucket_bytes=8)
    np.testing.assert_array_equal(p2.grad.numpy(), np.full((2, 2), 4.0))


def test_error_bound_budget_falls_back_to_fp32(meshes):
    jm, tm = meshes
    g = (np.random.RandomState(9).randn(2, 600) * 3).astype(np.float32)
    for bound in (0.0, 1e9):
        with jcc.configure(compress="int8", error_bound=bound):
            want, ref = _jax_sync(jm, {"w": g}, {})
        with configure(compress="int8", error_bound=bound):
            hook = BucketedGradSync(axes=("dp",), mesh=tm)
        got = hook(_shards({"w": g}))
        plain = (g[0] + g[1]) / 2
        np.testing.assert_array_equal(ref["w"], plain)
        if bound == 0.0:           # always fp32: the plain mean
            for s in range(2):
                np.testing.assert_array_equal(got[s]["w"].numpy(), plain)
            np.testing.assert_array_equal(want["w"], plain)
        else:                      # the quantized result, within its bound
            err = np.abs(got[0]["w"].numpy() - plain).max()
            assert err > 0
            b = float(cc.int8_error_bound(
                np.abs(g).max(), 2, bucket_absmax_out=np.abs(
                    g[0] + g[1]).max())) / 2
            assert err <= b
            assert np.abs(want["w"] - plain).max() <= b
            np.testing.assert_allclose(got[0]["w"].numpy(), want["w"],
                                       atol=2 * b)


def test_partially_bound_axes_raise(meshes):
    _, tm = meshes
    hook = BucketedGradSync(axes=("dp", "mp"), mesh=tm)
    with pytest.raises(ValueError, match="only .* bound"):
        hook([{"w": torch.ones(4)}, {"w": torch.ones(4)}])
    with pytest.raises(ValueError, match="3 shards"):
        BucketedGradSync(axes=("dp",), mesh=tm)(
            [{"w": torch.ones(4)}] * 3)


def test_hook_is_the_identity_outside_a_shard_list(meshes):
    _, tm = meshes
    hook = BucketedGradSync(axes=("dp",), mesh=tm)
    g = {"w": torch.arange(6, dtype=torch.float32)}
    out = hook(g)
    assert out is g and torch.equal(out["w"], torch.arange(6.0))
    assert hook({}) == {}


def test_attach_grad_sync_flag_wiring():
    net = torch.nn.Linear(4, 2)
    opt = AdamW(learning_rate=0.1, parameters=net.parameters())
    assert attach_grad_sync(opt, axes=("dp",)) is None    # default off
    assert opt._grad_sync is None
    with configure(bucketed_grad_sync=True):
        hook = attach_grad_sync(opt, axes=("dp",))
    assert hook is opt._grad_sync and isinstance(hook, BucketedGradSync)
    # flag off: a re-attach clears the stale bucketed hook, leaves a
    # user's own alone
    assert attach_grad_sync(opt, axes=("mp",)) is None
    assert opt._grad_sync is None
    custom = lambda g: g                                   # noqa: E731
    opt._grad_sync = custom
    attach_grad_sync(opt, axes=("dp",))
    assert opt._grad_sync is custom
    # a step with the hook attached (a dict: nothing bound) equals one
    # without it
    opt._grad_sync = hook
    torch.manual_seed(0)
    net2 = torch.nn.Linear(4, 2)
    net2.load_state_dict(net.state_dict())
    opt2 = AdamW(learning_rate=0.1, parameters=net2.parameters())
    for n, o in ((net, opt), (net2, opt2)):
        (n(torch.ones(3, 4)) ** 2).mean().backward()
        o.step()
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)


def test_group_sharded_attaches_the_hook_behind_the_flag():
    from paddle_tpu_torch.distributed import group_sharded_parallel
    net = torch.nn.Linear(8, 4)
    opt = AdamW(learning_rate=0.1, parameters=net.parameters())
    group_sharded_parallel(net, opt, "os")
    assert opt._grad_sync is None
    with configure(bucketed_grad_sync=True):
        group_sharded_parallel(net, opt, "os")
    assert isinstance(opt._grad_sync, BucketedGradSync)
    assert opt._grad_sync.axes == ("sharding",)     # JAX's without a mesh


def test_comms_bench_keys_bytes_and_gates_equal_jax(meshes):
    jm, tm = meshes
    want = jcc.run_comms_bench(size_mb=0.1, iters=1, mesh=jm)
    got = run_comms_bench(size_mb=0.1, iters=1, mesh=tm)
    assert set(got) == set(want)
    for k in ("devices", "axes", "mode", "payload_mb"):
        assert got[k] == want[k], k
    for op in ("all_reduce", "reduce_scatter", "all_gather",
               "all_reduce_int8"):
        assert set(got[op]) == set(want[op]), op
        assert got[op]["bytes_moved"] == want[op]["bytes_moved"], op
        # algbw is bytes over the unrounded time, rounded to 3 places as
        # JAX's (a loaded host can take it to 0.0 at this payload)
        assert got[op]["time_ms"] > 0
        assert got[op]["algbw_gbps"] == pytest.approx(
            got[op]["bytes_moved"] / (got[op]["time_ms"] * 1e6), rel=1e-2,
            abs=1e-3)
    q, jq = got["all_reduce_int8"], want["all_reduce_int8"]
    assert q["within_bound"] and q["constant_exact"]
    assert q["max_error"] == got["quant_vs_fp32_max_error"]
    np.testing.assert_allclose(q["error_bound"], jq["error_bound"],
                               rtol=1e-6)
    assert q["bytes_moved"] < got["all_reduce"]["bytes_moved"]


def test_comms_bench_needs_a_mesh_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from paddle_tpu_torch.distributed import mesh as tmesh
    monkeypatch.setattr(tmesh, "_CURRENT_MESH", None)
    with pytest.raises(RuntimeError, match="mesh="):
        run_comms_bench(size_mb=0.01, iters=1)
