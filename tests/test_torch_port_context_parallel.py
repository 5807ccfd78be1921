"""The port's context-parallel attention against the JAX package, on the
CPU.

Port side: ``distributed.context_parallel``'s ``ring_attention_spmd``,
``ulysses_attention_spmd`` and ``megatron_attention`` over fleet's sep
group in 2- and 4-rank gloo jobs (``launch_pod``, the worker below): each
rank passes its contiguous piece of q, k and v, takes the output's piece
and backpropagates its piece of one cotangent, so each rank's q, k and v
gradients are its pieces of the whole loss's. JAX side: the global
arrays through JAX's ``ring_attention_spmd`` and
``ulysses_attention_spmd`` on a 2- or 4-device ``"sep"`` mesh (built as
``tests/test_context_parallel.py`` builds it) and through the dense
``_xla_sdpa`` (megatron has no JAX function: GSPMD gathers for it), the
gradients from ``jax.value_and_grad``. Held in fp32 within 1e-5
relative (of each array's largest magnitude): causal and not, GQA (h 4,
hk 2; Ulysses repeats K/V when hk is not a multiple of S), Ulysses's
``ValueError`` when h is not, the S = 1 path and ``RingAttention``.
The exchanges are counted (``sep_ops.sep_stats``). The ring's blocks
(the port's ``flash_block``, its plain version here) are held against
JAX's ``flash_block`` running its Pallas kernels in interpret mode, with
an lse cotangent, and the port's ``_xla_block`` against JAX's."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from paddle_tpu.distributed import context_parallel as jcp
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas.flash_attention import _xla_sdpa

from paddle_tpu_torch.distributed import context_parallel as tcp
from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod
from paddle_tpu_torch.ops import flash_attention as tfa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
B, SEQ, D = 2, 32, 8
# name -> (function, causal, heads, kv heads)
CASES = {
    "ring_causal": ("ring", True, 4, 4),
    "ring_full": ("ring", False, 4, 4),
    "ring_gqa": ("ring", True, 4, 2),
    "ulysses_causal": ("ulysses", True, 4, 4),
    "ulysses_full": ("ulysses", False, 4, 4),
    "ulysses_gqa": ("ulysses", True, 4, 2),
    "megatron_causal": ("megatron", True, 4, 4),
    "megatron_full": ("megatron", False, 4, 4),
    "megatron_gqa": ("megatron", True, 4, 2),
}

WORKER = r'''
import faulthandler, json, os, sys
faulthandler.dump_traceback_later(300, exit=True)
import numpy as np
import torch
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import communication as C
from paddle_tpu_torch.distributed import context_parallel as cp
from paddle_tpu_torch.distributed import fleet, sep_ops

out = sys.argv[1]
with open(os.path.join(out, "cases.json")) as f:
    cases = json.load(f)
dist.init_parallel_env(device="cpu")
rank, world = dist.get_rank(), dist.get_world_size()
st = fleet.DistributedStrategy()
st.hybrid_configs = {"dp_degree": 1, "sep_degree": world}
fleet.init(is_collective=True, strategy=st)
g = fleet.get_hybrid_communicate_group().get_sep_parallel_group()
fns = {"ring": cp.ring_attention_spmd, "ulysses": cp.ulysses_attention_spmd,
       "megatron": cp.megatron_attention}
rec = {"group": g.ranks, "calls": {}, "raised": {}}
for name, c in cases.items():
    z = np.load(os.path.join(out, c["inputs"]))
    sl = z["q"].shape[1] // world

    def piece(a):
        return torch.from_numpy(a[:, rank * sl:(rank + 1) * sl].copy())
    q, k, v = (piece(z[n]).requires_grad_() for n in ("q", "k", "v"))
    if c.get("raises"):
        try:
            fns[c["fn"]](q, k, v, group=g, causal=c["causal"])
            rec["raised"][name] = None
        except ValueError as e:
            rec["raised"][name] = str(e)
        continue
    sep_ops.reset_sep_stats()
    o = fns[c["fn"]](q, k, v, group=g, causal=c["causal"])
    (o * piece(z["do"])).sum().backward()
    rec["calls"][name] = {kk: vv["calls"]
                          for kk, vv in sep_ops.sep_stats().items()}
    np.savez(os.path.join(out, f"{name}_{rank}.npz"),
             o=o.detach().numpy(), dq=q.grad.numpy(), dk=k.grad.numpy(),
             dv=v.grad.numpy())
    if name == "ring_causal":       # the facade over fleet's sep group
        with torch.no_grad():
            facade = cp.RingAttention()(q, k, v)
        rec["facade_equal"] = bool(torch.equal(facade, o.detach()))
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
C.barrier()
C.destroy_process_group()
'''


def _inputs(h, hk, seed):
    rs = np.random.RandomState(seed)
    return {"q": rs.randn(B, SEQ, h, D).astype(np.float32),
            "k": rs.randn(B, SEQ, hk, D).astype(np.float32),
            "v": rs.randn(B, SEQ, hk, D).astype(np.float32),
            "do": rs.randn(B, SEQ, h, D).astype(np.float32)}


def _launch(tmp, world, cases):
    script = tmp / "worker.py"
    script.write_text(WORKER)
    (tmp / "cases.json").write_text(json.dumps(cases))
    cfg = LaunchConfig(str(script), [str(tmp)], nproc_per_node=world,
                       log_dir=str(tmp / "log"),
                       envs={"OMP_NUM_THREADS": "1",
                             "PYTHONPATH": REPO + os.pathsep
                             + os.environ.get("PYTHONPATH", "")})
    rc = launch_pod(cfg)
    logs = {p.name: p.read_text()[-3000:] for p in (tmp / "log").iterdir()}
    assert rc == 0, logs


def _jax_grads(fn, x, causal):
    """(o, dq, dk, dv) of ``fn(q, k, v)`` with the loss sum(o * do)."""
    def loss(q, k, v):
        o = fn(q, k, v)
        return jnp.sum(o * x["do"]), o
    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(x["q"], x["k"], x["v"])
    return (np.asarray(o),) + tuple(np.asarray(g) for g in grads)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both port jobs' outputs (global arrays) and the JAX results."""
    root = tmp_path_factory.mktemp("context_parallel")
    inputs = {}
    for name, (_, _, h, hk) in CASES.items():
        inputs.setdefault((h, hk), _inputs(h, hk, seed=h + hk))
    out = {}
    for world in (2, 4):
        tmp = root / f"w{world}"
        tmp.mkdir()
        cases = {}
        for (h, hk), x in inputs.items():
            np.savez(tmp / f"x_{h}_{hk}.npz", **x)
        for name, (fn, causal, h, hk) in CASES.items():
            cases[name] = {"fn": fn, "causal": causal,
                           "inputs": f"x_{h}_{hk}.npz"}
        # Ulysses needs h divisible by S
        bad = 3 if world == 2 else 6
        np.savez(tmp / "x_bad.npz", **_inputs(bad, bad, seed=1))
        cases["ulysses_heads"] = {"fn": "ulysses", "causal": True,
                                  "inputs": "x_bad.npz", "raises": True}
        _launch(tmp, world, cases)
        recs = [json.loads((tmp / f"rank{r}.json").read_text())
                for r in range(world)]
        got = {}
        for name in CASES:
            parts = [np.load(tmp / f"{name}_{r}.npz") for r in range(world)]
            got[name] = {k: np.concatenate([p[k] for p in parts], axis=1)
                         for k in ("o", "dq", "dk", "dv")}
        out[world] = (recs, got)
    return inputs, out


# the dense results, one a case for both job sizes
_DENSE = {}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(jobs, name, world):
    """Output and q/k/v gradients against the dense ``_xla_sdpa`` and, for
    the ring and Ulysses, JAX's own function on a ``"sep"`` mesh of the
    same size."""
    inputs, out = jobs
    fn, causal, h, hk = CASES[name]
    x = {k: jnp.asarray(v) for k, v in inputs[(h, hk)].items()}
    _, got = out[world]
    if name not in _DENSE:
        _DENSE[name] = _jax_grads(lambda q, k, v: _xla_sdpa(
            q, k, v, None, causal, 0.0, None), x, causal)
    dense = _DENSE[name]
    wants = [("dense", dense)]
    if fn != "megatron":
        mesh = Mesh(np.array(jax.devices()[:world]), ("sep",))
        jfn = jcp.ring_attention_spmd if fn == "ring" \
            else jcp.ulysses_attention_spmd
        wants.append(("jax", _jax_grads(
            lambda q, k, v: jfn(q, k, v, mesh=mesh, causal=causal), x,
            causal)))
    for label, want in wants:
        for key, w in zip(("o", "dq", "dk", "dv"), want):
            _close(got[name][key], w, f"{name} S={world} {key} vs {label}")


@pytest.mark.parametrize("world", [2, 4])
def test_exchanges_and_errors(jobs, world):
    """One pass of the ring a call (S - 1 hops, then as many reverse
    hops), Ulysses' three all-to-alls each way, megatron's gather and its
    reduce-scatter; Ulysses refuses heads it cannot split with JAX's
    message; ``RingAttention`` over fleet's sep group is the ring."""
    recs, _ = jobs[1][world]
    for rec in recs:
        assert rec["group"] == list(range(world))
        for name, calls in rec["calls"].items():
            fn = CASES[name][0]
            want = {"hop": 2 * (world - 1) if fn == "ring" else 0,
                    "all_to_all": 6 if fn == "ulysses" else 0,
                    "all_gather": 1 if fn == "megatron" else 0,
                    "reduce_scatter": 1 if fn == "megatron" else 0,
                    "all_reduce": 0, "grad_sum": 0}
            assert calls == want, (name, calls)
        assert "not divisible by sep degree" in rec["raised"]["ulysses_heads"]
        assert rec["facade_equal"]


def test_one_rank_and_no_group():
    """S = 1 (no group): every function and ``RingAttention`` are the
    port's ``sdpa``, which is JAX's S = 1 result (``fa.sdpa``)."""
    x = _inputs(4, 2, seed=3)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    want = np.asarray(jcp.ring_attention_spmd(
        *(jnp.asarray(x[n]) for n in "qkv"),
        mesh=Mesh(np.array(jax.devices()[:1]), ("sep",)), causal=True))
    base = tfa.sdpa(t["q"], t["k"], t["v"], is_causal=True)
    _close(base.numpy(), want, "sdpa vs JAX S=1")
    for fn in (tcp.ring_attention_spmd, tcp.ulysses_attention_spmd,
               tcp.megatron_attention):
        assert torch.equal(fn(t["q"], t["k"], t["v"], group=None), base)
    assert torch.equal(tcp.RingAttention()(t["q"], t["k"], t["v"]), base)
    assert tcp.sep_degree(None) == 1


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's flash kernels in interpret mode."""
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_blocks_match_jax_flash_block(interpret, causal):
    """One ring block (GQA, b 1, 64 x 64): the port's ``flash_block`` and
    ``_xla_block`` against JAX's ``flash_block`` (Pallas, interpret) and
    ``_xla_block``: (o, lse), and the q/k/v gradients of a loss that
    weighs both (the lse cotangent the merge gives a block)."""
    rs = np.random.RandomState(5)
    q = rs.randn(1, 64, 4, 64).astype(np.float32)
    k = rs.randn(1, 64, 2, 64).astype(np.float32)
    v = rs.randn(1, 64, 2, 64).astype(np.float32)
    wo = rs.randn(1, 64, 4, 64).astype(np.float32)
    wl = rs.randn(1, 4, 64).astype(np.float32)
    scale = 1.0 / 8.0

    def jloss(block):
        def f(qv, kv, vv):
            o, lse = block(qv, kv, vv, causal, scale)
            return jnp.sum(o * wo) + jnp.sum(lse * wl), (o, lse)
        return jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    (_, (jo, jlse)), jg = jloss(jfa.flash_block)
    (_, (xo, xlse)), xg = jloss(jcp._xla_block)
    for block in (tfa.flash_block, tcp._xla_block):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v))
        o, lse = block(qt, kt, vt, causal, scale)
        ((o * torch.from_numpy(wo)).sum()
         + (lse * torch.from_numpy(wl)).sum()).backward()
        for want_o, want_lse, want_g in ((jo, jlse, jg), (xo, xlse, xg)):
            _close(o.detach().numpy(), np.asarray(want_o), "o")
            _close(lse.detach().numpy(), np.asarray(want_lse), "lse")
            for got, w in zip((qt.grad, kt.grad, vt.grad), want_g):
                _close(got.numpy(), np.asarray(w), "grad")


def test_merge_blocks_matches_jax():
    """The fp32 online merge of two (o, lse) pairs, a dead (-inf) row
    included."""
    rs = np.random.RandomState(6)
    o, ob = (rs.randn(1, 8, 2, 4).astype(np.float32) for _ in range(2))
    lse, lseb = (rs.randn(1, 2, 8).astype(np.float32) for _ in range(2))
    lse[0, 0, 0] = lseb[0, 0, 0] = -np.inf
    jo, jl = jcp._merge_blocks(*(jnp.asarray(a) for a in (o, lse, ob,
                                                          lseb)))
    to, tl = tcp._merge_blocks(*(torch.from_numpy(a) for a in (o, lse, ob,
                                                               lseb)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL)
