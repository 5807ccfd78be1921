"""The port's MoE routing, row gather and MoE layer against the JAX
package, on the CPU.

- ``build_index_maps`` and the top-k routing: integer-equal to the JAX
  functions, with capacity drops and deliberate ties among the logits
  (ties break toward the lower expert id in both).
- The plain ``gather_rows`` against the Pallas gathers in interpret mode
  (``_gather_rows_pallas`` and ``_gather_rows_pallas_mr``), with
  out-of-range indices and m % R != 0: bit for bit (a copy).
- ``moe_dispatch``/``moe_combine`` forward and backward against the JAX
  custom VJPs (``jax.vjp``): 1e-6 (fp32; the combine sums k products).
- ``MoELayer`` output and gradients against the JAX layer in its
  "gather" and "scatter" dispatch modes (the port has the one dispatch)
  and ``forward_dense`` with the GShard gate, and with the Switch and
  naive gates (d 128, E 4): 1e-5 (fp32 products summed in other orders
  by XLA and torch).
The CUDA kernel itself runs only on a GPU (test_torch_port_gpu.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.ops.pallas import moe_dispatch as jmd

from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.incubate.distributed.models import MoELayer
from paddle_tpu_torch.incubate.distributed.models.moe import _top_k
from paddle_tpu_torch.ops import moe_dispatch as tmd


def _tied_logits(rs, t, e):
    """bf16-like logits drawn from a few values, so that ties among the
    experts are common."""
    return (rs.randint(-3, 4, (t, e)) * 0.25).astype(np.float32)


@pytest.mark.parametrize("k,cap", [(2, 6), (2, 40), (1, 3)])
def test_routing_is_integer_equal_to_jax(k, cap):
    rs = np.random.RandomState(k + cap)
    t, e = 32, 4
    lg = _tied_logits(rs, t, e)
    assert (np.sort(lg, -1)[:, -1] == np.sort(lg, -1)[:, -2]).any()
    _, jtopi = jax.lax.top_k(jnp.asarray(lg), k)
    _, ttopi = _top_k(torch.from_numpy(lg), k)
    np.testing.assert_array_equal(ttopi.numpy(), np.asarray(jtopi))
    jslot, jinv, jkeep = jmd.build_index_maps(jtopi, e, cap)
    tslot, tinv, tkeep = tmd.build_index_maps(ttopi, e, cap)
    assert tslot.dtype == tinv.dtype == torch.int32
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    if cap < t * k // e:
        assert not tkeep.all()          # capacity drops were exercised


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jmd, "_FORCE_INTERPRET", True)


_IDX = np.array([0, 5, 9, -2, 3, 10, 99, 7, 1, 9, 2, 0, 4], np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 4, 8])
def test_plain_gather_is_bit_equal_to_pallas(interpret, dtype, rows):
    """T = 10: -2, 10 and 99 are out of range; m = 13 is no multiple of
    4 or 8."""
    rs = np.random.RandomState(rows)
    x = jnp.asarray(rs.randn(10, 128).astype(np.float32)).astype(dtype)
    idx = jnp.asarray(_IDX)
    want = jmd._gather_rows_pallas(x, idx) if rows == 1 \
        else jmd._gather_rows_pallas_mr(x, idx, rows_per_step=rows)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tmd.gather_rows_reference(xt, torch.from_numpy(_IDX))
    assert got.dtype == xt.dtype and got.shape == (13, 128)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert not got[[3, 5, 6]].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_gather_rows_takes_the_plain_version_on_cpu(dtype):
    """A CPU tensor of any dtype takes the plain version and launches
    nothing (on a CUDA one the kernel launches or raises:
    test_torch_port_gpu.py)."""
    x = torch.randn(10, 96).to(dtype)
    idx = torch.from_numpy(_IDX)
    ops.reset_launch_counts()
    torch.testing.assert_close(tmd.gather_rows(x, idx),
                               tmd.gather_rows_reference(x, idx),
                               rtol=0, atol=0)
    assert ops.launch_counts()["moe_gather"] == 0


def _maps(rs, t, k, e, cap):
    topi = np.stack([rs.permutation(e)[:k] for _ in range(t)]) \
        .astype(np.int32)
    slot, inv, _ = jmd.build_index_maps(jnp.asarray(topi), e, cap)
    return np.array(slot), np.array(inv)


@pytest.mark.parametrize("cap", [3, 16])
def test_dispatch_and_combine_match_jax_vjp(cap):
    rs = np.random.RandomState(cap)
    t, k, e, d = 12, 2, 4, 16
    slot, inv = _maps(rs, t, k, e, cap)
    x = rs.randn(t, d).astype(np.float32)
    flat = rs.randn(e * cap, d).astype(np.float32)
    gates = rs.rand(t, k).astype(np.float32)
    dbuf = rs.randn(e * cap, d).astype(np.float32)
    dout = rs.randn(t, d).astype(np.float32)

    jbuf, jvjp = jax.vjp(lambda a: jmd.moe_dispatch(a, jnp.asarray(inv),
                                                    jnp.asarray(slot)),
                         jnp.asarray(x))
    (jdx,) = jvjp(jnp.asarray(dbuf))
    jout, cvjp = jax.vjp(lambda f, g: jmd.moe_combine(
        f, g, jnp.asarray(inv), jnp.asarray(slot)),
        jnp.asarray(flat), jnp.asarray(gates))
    jdflat, jdgates = cvjp(jnp.asarray(dout))

    xt = torch.from_numpy(x).requires_grad_()
    buf = tmd.moe_dispatch(xt, torch.from_numpy(inv), torch.from_numpy(slot))
    buf.backward(torch.from_numpy(dbuf))
    ft = torch.from_numpy(flat).requires_grad_()
    gt = torch.from_numpy(gates).requires_grad_()
    out = tmd.moe_combine(ft, gt, torch.from_numpy(inv),
                          torch.from_numpy(slot))
    out.backward(torch.from_numpy(dout))
    for got, want in ((buf, jbuf), (xt.grad, jdx), (out, jout),
                      (ft.grad, jdflat), (gt.grad, jdgates)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


def _layer_pair(gate, mode, cap, seed):
    """The JAX layer in dispatch ``mode`` (random weights from numpy,
    biases included) and the port's with the same weights."""
    kw = dict(d_model=128, num_expert=4, d_hidden=64, top_k=2,
              capacity_factor=cap, gate=gate)
    paddle.seed(seed)
    jl = jmoe.MoELayer(**kw, dispatch_mode=mode)
    rs = np.random.RandomState(seed)
    for _, p in jl.named_parameters():
        # weights at 1/sqrt(fan_in) (the JAX (in, out) layout), biases 0.1
        std = 0.1 if p.shape[-2] == 1 or len(p.shape) == 1 \
            else p.shape[-2] ** -0.5
        p.set_value(paddle.to_tensor(
            (std * rs.randn(*p.shape)).astype(np.float32)))
    tl = MoELayer(**kw, device="cpu")
    tl.load_state_dict(params_from_jax(
        {n: np.asarray(p._value) for n, p in jl.named_parameters()}))
    return jl, tl


def _jax_run(jl, xv, ct, dense):
    x = paddle.to_tensor(xv)
    x.stop_gradient = False
    out = jl.forward_dense(x) if dense else jl(x)
    loss = (out * paddle.to_tensor(ct)).sum()
    if jl.l_aux is not None:
        loss = loss + jl.l_aux
    loss.backward()
    grads = params_from_jax({n: np.asarray(p.grad._value)
                             for n, p in jl.named_parameters()
                             if p.grad is not None})
    return out.numpy(), x.grad.numpy(), grads


def _port_run(tl, xv, ct, dense):
    x = torch.from_numpy(xv).requires_grad_()
    out = tl.forward_dense(x) if dense else tl(x)
    loss = (out * torch.from_numpy(ct)).sum()
    if tl.l_aux is not None:
        loss = loss + tl.l_aux
    loss.backward()
    grads = {n: p.grad for n, p in tl.named_parameters()
             if p.grad is not None}
    return out.detach().numpy(), x.grad.numpy(), grads


@pytest.mark.parametrize("gate,mode", [
    ("gshard", "gather"), ("gshard", "scatter"), ("gshard", "dense"),
    ("switch", "gather"), ("naive", "gather")])
def test_moe_layer_matches_jax(gate, mode):
    """Capacity factor 0.75: some tokens are dropped. The gate decides
    the routing and the JAX layer's mode how tokens move, independently,
    so the Switch and naive gates run in the default mode; the port's
    one dispatch matches either JAX mode."""
    jl, tl = _layer_pair(gate, "scatter" if mode == "scatter" else "gather",
                         0.75, seed=3)
    rs = np.random.RandomState(4)
    xv = rs.randn(2, 16, 128).astype(np.float32)
    ct = rs.randn(2, 16, 128).astype(np.float32)
    dense = mode == "dense"
    jout, jgx, jgrads = _jax_run(jl, xv, ct, dense)
    tout, tgx, tgrads = _port_run(tl, xv, ct, dense)
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tgx, jgx, atol=1e-5, rtol=1e-5)
    assert set(tgrads) == set(jgrads)
    for n, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=n)


def test_moe_layer_matches_jax_pallas_gather(monkeypatch, interpret):
    """The JAX layer on its multi-row Pallas gather
    (``PT_MOE_GATHER=pallas_mr``, interpret mode) gives the port's layer
    output."""
    jl, tl = _layer_pair("gshard", "gather", 0.75, seed=5)
    xv = np.random.RandomState(6).randn(1, 16, 128).astype(np.float32)
    monkeypatch.setenv("PT_MOE_GATHER", "pallas_mr")
    jout = jl(paddle.to_tensor(xv)).numpy()
    tout = tl(torch.from_numpy(xv)).detach().numpy()
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=1e-5)
