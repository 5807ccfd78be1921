"""The RMSNorm gradient of the port against the JAX package, on the CPU.

``ops.fused.rms_norm_backward_reference`` (the plain version of the
backward kernel in ``csrc/rms_norm.cu``) is held against JAX's
``_rms_bwd`` (``jax.vjp`` of ``paddle_tpu.ops.pallas.fused._rms_ref``)
and against torch's autograd of ``rms_norm_reference``; the residual
entry's backward against the JAX residual VJP; the entry points on CPU
tensors launch nothing and equal the plain version, long rows included;
the kernels' launch plan covers every row. Inputs come from numpy seeds.

Tolerances (the two sides sum in other orders, and XLA and torch may
also regroup the VJP's terms):
- fp32: dx and dw within 1e-5 absolute + 1e-5 relative. Measured at
  (512, 256): dx 9.5e-7, dw 1.3e-5 at |dw| up to 66.
- bf16 dx: one bf16 ulp of the value (+ 1e-6 absolute). Both sides
  round one fp32 value, a few fp32 ulp apart, to bf16 once.
- bf16 dw: two bf16 ulps of the value (+ 1e-6 absolute). dw sums
  ``rows`` products, each rounded to bf16, in fp32 and rounds the sum
  once, as XLA does on a TPU or a GPU; another summation order moves the
  fp32 sum by a few of its ulps, which can flip the final rounding by one
  bf16 ulp, and a product cast(ct·n) whose n rounded the other way (r a
  fp32 ulp apart) moves it by a fraction of one term's bf16 ulp. A wrong
  formula (a missed rounding site, r², h − 1) misses by many ulps.
  XLA's CPU backend, which runs the JAX side here, accumulates a bf16
  column sum in bf16 (at 8 rows its dw equals a sequential bf16 sum bit
  for bit), dozens of ulps from the fp32 sum where the terms cancel. So
  the JAX side's dw is taken as JAX's own per-element cotangent of a
  weight broadcast to (rows, h) (the products cast(ct·n), computed by
  the VJP of ``_rms_ref``), summed over the rows in fp32 and rounded
  once. Measured at (512, 4096): 0 ulps for dw, 1 for dx."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused as jfused

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import build
from paddle_tpu_torch.ops.fused import (fused_rms_norm, rms_norm,
                                        rms_norm_backward_reference,
                                        rms_norm_plan, rms_norm_reference,
                                        rms_norm_residual_reference)

EPS = 1e-5
SHAPES = [(1, 64), (8, 64), (37, 256), (512, 256)]
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _case(rows, h, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, h).astype(np.float32)
    w = (1 + 0.1 * rs.randn(h)).astype(np.float32)
    ct = rs.randn(rows, h).astype(np.float32)
    r = rs.randn(rows, h).astype(np.float32)
    return x, w, ct, r


def _bf16_ulp(v):
    """One bf16 ulp of each value (8 significant bits)."""
    v = np.abs(v.astype(np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(v, 2.0 ** -126))) - 7)


def _close(got, want, dtype, ulps):
    """``got`` within the tolerance of the module docstring: fp32 1e-5
    absolute + 1e-5 relative; bf16 ``ulps`` bf16 ulps of the value."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    if dtype == "fp32":
        bound = 1e-5 + 1e-5 * np.abs(want)
    else:
        bound = 1e-6 + ulps * _bf16_ulp(want)
    worst = np.argmax(err - bound)
    assert (err <= bound).all(), (float(err.flat[worst]),
                                  float(want.flat[worst]))


def _torch(a, dtype):
    return torch.from_numpy(a).to(DTYPES[dtype][0])


def _jax(a, dtype):
    return jnp.asarray(a).astype(DTYPES[dtype][1])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _jax_vjp(x, w, cts, dtype, r=None):
    """JAX's VJP of ``_rms_ref`` (with a residual when ``r`` is given)
    for the cotangents ``cts``: (dx, [dr,] dw), dw from the per-element
    cotangent of a broadcast weight summed over the rows in fp32 and
    rounded once (see the module docstring)."""
    rows, h = x.shape
    wb = jnp.broadcast_to(_jax(w, dtype), (rows, h))
    args = (_jax(x, dtype), wb) + (() if r is None else (_jax(r, dtype),))


    def f(a, b, *res):
        return jfused._rms_ref(a, b, EPS, res[0] if res else None)

    _, vjp = jax.vjp(f, *args)
    grads = vjp(cts)
    dw = jnp.sum(grads[1].astype(jnp.float32), axis=0).astype(wb.dtype)
    return (grads[0],) + tuple(grads[2:]) + (dw,)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,h", SHAPES)
def test_backward_reference_matches_jax_vjp(rows, h, dtype):
    x, w, ct, _ = _case(rows, h, seed=rows + h)
    jdx, jdw = _jax_vjp(x, w, _jax(ct, dtype), dtype)
    dx, dw = rms_norm_backward_reference(_torch(x, dtype), _torch(w, dtype),
                                         _torch(ct, dtype), EPS)
    assert dx.dtype == dw.dtype == DTYPES[dtype][0]
    _close(_np(dx), _np(jdx), dtype, ulps=1)
    _close(_np(dw), _np(jdw), dtype, ulps=2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,h", SHAPES)
def test_backward_reference_matches_torch_autograd(rows, h, dtype):
    """The formulas written out against torch's own VJP of the plain
    forward (the port's gradient before the backward kernel): bit for bit
    on the CPU, as they are autograd's operations in autograd's order."""
    x, w, ct, _ = _case(rows, h, seed=2 * rows + h)
    xt = _torch(x, dtype).requires_grad_()
    wt = _torch(w, dtype).requires_grad_()
    rms_norm_reference(xt, wt, EPS).backward(_torch(ct, dtype))
    dx, dw = rms_norm_backward_reference(xt.detach(), wt.detach(),
                                         _torch(ct, dtype), EPS)
    assert torch.equal(dx, xt.grad) and torch.equal(dw, wt.grad)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,h", [(8, 64), (37, 256)])
def test_residual_backward_matches_jax_vjp(rows, h, dtype):
    """``fused_rms_norm(residual=)`` on CPU tensors through autograd
    against the VJP of ``_rms_ref`` with a residual (the JAX residual
    ``custom_vjp`` backward) for both outputs' cotangents: x and the
    residual get the same gradient, the RMS part rounded to x's dtype and
    then the sum's cotangent added in x's dtype."""
    x, w, ct, r = _case(rows, h, seed=3 * rows + h)
    g_sum = np.random.RandomState(rows).randn(rows, h).astype(np.float32)
    jdx, jdr, jdw = _jax_vjp(x, w, (_jax(ct, dtype), _jax(g_sum, dtype)),
                             dtype, r=r)
    xt, rt, wt = (_torch(a, dtype).requires_grad_() for a in (x, r, w))
    out, total = fused_rms_norm(xt, wt, EPS, residual=rt)
    torch.autograd.backward((out, total), (_torch(ct, dtype),
                                           _torch(g_sum, dtype)))
    # one bf16 ulp more for dx: the RMS part and the sum round once each
    _close(_np(xt.grad), _np(jdx), dtype, ulps=2)
    _close(_np(rt.grad), _np(jdr), dtype, ulps=2)
    _close(_np(wt.grad), _np(jdw), dtype, ulps=2)
    assert torch.equal(xt.grad, rt.grad)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_backward_launches_nothing(dtype):
    """On CPU tensors both entry points' backwards run the plain version:
    no launch is counted and nothing is built, and the gradients equal
    ``rms_norm_backward_reference`` (plus the sum's cotangent)."""
    x, w, ct, r = _case(8, 256, seed=5)
    ops.reset_launch_counts()
    xt, wt = _torch(x, dtype).requires_grad_(), _torch(w, dtype)
    wt.requires_grad_()
    rms_norm(xt, wt, EPS).backward(_torch(ct, dtype))
    dx, dw = rms_norm_backward_reference(_torch(x, dtype), _torch(w, dtype),
                                         _torch(ct, dtype), EPS)
    assert torch.equal(xt.grad, dx) and torch.equal(wt.grad, dw)
    xs, rs_, ws = (_torch(a, dtype).requires_grad_() for a in (x, r, w))
    out, total = fused_rms_norm(xs, ws, EPS, residual=rs_)
    torch.autograd.backward((out, total), (_torch(ct, dtype),
                                           torch.ones_like(total)))
    s = _torch(x, dtype) + _torch(r, dtype)
    ds, dws = rms_norm_backward_reference(s, _torch(w, dtype),
                                          _torch(ct, dtype), EPS)
    assert torch.equal(xs.grad, ds + 1) and torch.equal(rs_.grad, ds + 1)
    assert torch.equal(ws.grad, dws)
    assert ops.launch_counts()["rms_norm_bwd"] == 0
    assert ops.launch_counts()["rms_norm_residual"] == 0
    assert "rms_norm" not in build._loaded


@pytest.mark.parametrize("wrt", ["x", "w"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_needs_input_grad(wrt, residual):
    """Only x (or the weight) wants a gradient: the other gets none, and
    the one asked for equals the full backward's."""
    x, w, ct, r = _case(37, 64, seed=11)
    xt, wt, rt = torch.from_numpy(x), torch.from_numpy(w), \
        torch.from_numpy(r)
    (xt if wrt == "x" else wt).requires_grad_()
    if residual:
        out, _ = fused_rms_norm(xt, wt, EPS, residual=rt)
        s = xt.detach() + rt
    else:
        out, s = rms_norm(xt, wt, EPS), xt.detach()
    out.backward(torch.from_numpy(ct))
    dx, dw = rms_norm_backward_reference(s, wt.detach(),
                                         torch.from_numpy(ct), EPS)
    if wrt == "x":
        assert wt.grad is None and torch.equal(xt.grad, dx)
    else:
        assert xt.grad is None and torch.equal(wt.grad, dw)


@pytest.mark.parametrize("elt", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("h", [64, 256, 1200, 4096, 8192, 11008, 16384,
                               65536])
def test_plan_covers_every_vector(h, elt):
    """The plan of both kernels: up to 1024 16-byte vectors the row held
    in registers by min(256, vectors) threads in whole warps (the first
    forward kernel's CTA, whose sums the forward keeps bit for bit), each
    with the fewest of 1, 2 or 4 vectors that cover the row; a longer
    row the looping instance (0 vectors a thread) at 256 threads."""
    nvec = h * elt // 16
    vpt, threads = rms_norm_plan(nvec)
    if nvec <= 1024:
        assert vpt in (1, 2, 4)
        assert threads == min(256, -(-nvec // 32) * 32)
        assert vpt * threads >= nvec
        assert vpt == 1 or (vpt // 2) * threads < nvec
    else:
        assert (vpt, threads) == (0, 256)


def test_plan_at_the_model_widths():
    assert rms_norm_plan(512) == (2, 256)        # bf16 h = 4096
    assert rms_norm_plan(1024) == (4, 256)       # fp32 h = 4096
    assert rms_norm_plan(300) == (2, 256)
    assert rms_norm_plan(3) == (1, 32)
    assert rms_norm_plan(1025) == (0, 256)       # past the registers


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_long_rows_on_the_cpu(dtype):
    """A row past the kernels' registers (h = 16384) through both entry
    points on CPU tensors: the plain versions, forward and backward,
    equal to the explicit formulas."""
    x, w, ct, r = _case(3, 16384, seed=13)
    xt, wt = _torch(x, dtype).requires_grad_(), _torch(w, dtype)
    wt.requires_grad_()
    out = rms_norm(xt, wt, EPS)
    out.backward(_torch(ct, dtype))
    assert torch.equal(out, rms_norm_reference(xt.detach(), wt.detach(),
                                               EPS))
    dx, dw = rms_norm_backward_reference(_torch(x, dtype), _torch(w, dtype),
                                         _torch(ct, dtype), EPS)
    assert torch.equal(xt.grad, dx) and torch.equal(wt.grad, dw)
    normed, total = fused_rms_norm(_torch(x, dtype), _torch(w, dtype), EPS,
                                   residual=_torch(r, dtype))
    want, want_total = rms_norm_residual_reference(
        _torch(x, dtype), _torch(r, dtype), _torch(w, dtype), EPS)
    assert torch.equal(normed, want) and torch.equal(total, want_total)
