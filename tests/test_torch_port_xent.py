"""The port's fused softmax cross-entropy against the JAX package, on the
CPU.

- The plain ``softmax_xent_rows`` forward (nll, lse) and backward (dx
  through both outputs) against the Pallas kernels in interpret mode
  at V = 512, and against the JAX scan route at V = 510 (one whole row:
  no divisor of 510 lies in [128, 4096] below it) and V = 8200 (four
  chunks of 2050). fp32: 2e-6 on nll/lse (sums of exps in another
  order) and 1e-7 + 1e-6 relative on dx; bf16 logits: the same, the
  math being fp32 after an exact upcast, and dx rounded once to bf16
  on both sides (one bf16 ulp).
- ``nn.functional.cross_entropy`` with ``PT_FUSION_PASSES`` off and on:
  ``ignore_index``, ``label_smoothing``, the three reductions, and bf16
  logits under ``auto_cast`` (black-cast to fp32 on both sides), loss
  and logits gradient against the JAX ``F.cross_entropy``: 1e-6.
- The tiny Llama with the unfused head (``fused_head_ce=False``) under
  ``PT_FUSION_PASSES=1``: loss and every gradient against the JAX
  model's, at the training tests' tolerances (1e-5 relative, 1e-4).
The CUDA kernels themselves run only on a GPU (test_torch_port_gpu.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import fused as jfused
from paddle_tpu.ops.pallas import xent as jxent

from paddle_tpu_torch import amp, ops
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.xent import (softmax_xent_rows,
                                       softmax_xent_rows_reference)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode."""
    monkeypatch.setattr(jfused, "_FORCE_INTERPRET", True)


def _inputs(n, v, seed, dtype="float32"):
    rs = np.random.RandomState(seed)
    x = (3 * rs.randn(n, v)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(dtype).astype(jnp.float32))
    labels = rs.randint(0, v, (n,)).astype(np.int32)
    g_nll, g_lse = rs.randn(n).astype(np.float32), \
        rs.randn(n).astype(np.float32)
    return x, labels, g_nll, g_lse


def _jax_rows(x, labels, g_nll, g_lse, dtype):
    (nll, lse), vjp = jax.vjp(
        lambda a: jxent.softmax_xent_rows(a, jnp.asarray(labels)),
        jnp.asarray(x).astype(dtype))
    (dx,) = vjp((jnp.asarray(g_nll), jnp.asarray(g_lse)))
    return (np.asarray(nll), np.asarray(lse),
            np.asarray(dx.astype(jnp.float32)))


def _port_rows(x, labels, g_nll, g_lse, dtype):
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    nll, lse = softmax_xent_rows(xt, torch.from_numpy(labels))
    assert nll.dtype == lse.dtype == torch.float32
    torch.autograd.backward((nll, lse), (torch.from_numpy(g_nll),
                                         torch.from_numpy(g_lse)))
    assert xt.grad.dtype == xt.dtype
    return (nll.detach().numpy(), lse.detach().numpy(),
            xt.grad.float().numpy())


def _assert_rows_close(got, want, dtype):
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, atol=2e-6, rtol=2e-7)
    if dtype == "float32":
        np.testing.assert_allclose(got[2], want[2], atol=1e-7, rtol=1e-6)
    else:       # each side rounds an fp32 value once: one bf16 ulp apart
        np.testing.assert_allclose(got[2], want[2], atol=1e-7,
                                   rtol=2.0 ** -8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_match_pallas_kernels(interpret, dtype):
    x, labels, g_nll, g_lse = _inputs(24, 512, 0, dtype)
    assert jxent._pallas_viable(jnp.asarray(x))
    want = _jax_rows(x, labels, g_nll, g_lse, dtype)
    _assert_rows_close(_port_rows(x, labels, g_nll, g_lse, dtype), want,
                       dtype)


@pytest.mark.parametrize("v", [510, 8200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_match_scan_route(dtype, v):
    x, labels, g_nll, g_lse = _inputs(6, v, 1, dtype)
    assert not jxent._pallas_viable(jnp.asarray(x))
    want = _jax_rows(x, labels, g_nll, g_lse, dtype)
    _assert_rows_close(_port_rows(x, labels, g_nll, g_lse, dtype), want,
                       dtype)


def test_rows_reference_matches_jax_reference():
    x, labels, _, _ = _inputs(8, 300, 2)
    want = jxent.softmax_xent_rows_reference(jnp.asarray(x),
                                             jnp.asarray(labels))
    got = softmax_xent_rows_reference(torch.from_numpy(x),
                                      torch.from_numpy(labels))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)


def test_rows_count_no_launch_on_cpu():
    x, labels, _, _ = _inputs(4, 64, 3)
    ops.reset_launch_counts()
    nll, _ = softmax_xent_rows(torch.from_numpy(x).requires_grad_(),
                               torch.from_numpy(labels))
    nll.sum().backward()
    assert ops.launch_counts()["xent_fwd"] == 0
    assert ops.launch_counts()["xent_bwd"] == 0


CE_CASES = {
    "plain": dict(),
    "ignore": dict(ignore_index=3),
    "smooth": dict(label_smoothing=0.1),
    "smooth_ignore_sum": dict(label_smoothing=0.2, ignore_index=3,
                              reduction="sum"),
    "none": dict(reduction="none", ignore_index=3),
}


@pytest.mark.parametrize("case", list(CE_CASES))
@pytest.mark.parametrize("fusion", [False, True], ids=["unfused", "fused"])
def test_cross_entropy_matches_jax(monkeypatch, case, fusion):
    monkeypatch.setenv("PT_FUSION_PASSES", "1" if fusion else "0")
    kw = CE_CASES[case]
    rs = np.random.RandomState(4)
    x = (2 * rs.randn(2, 7, 384)).astype(np.float32)
    labels = rs.randint(0, 384, (2, 7)).astype(np.int32)
    labels[0, :3] = 3            # rows the ignore_index cases drop
    ct = rs.randn(2, 7).astype(np.float32) if kw.get("reduction") == "none" \
        else np.float32(1.0)

    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jl = JF.cross_entropy(jx, paddle.to_tensor(labels), **kw)
    (jl * paddle.to_tensor(ct)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    tl = PF.cross_entropy(tx, torch.from_numpy(labels), **kw)
    (tl * torch.from_numpy(np.asarray(ct))).sum().backward()
    np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("fusion", [False, True], ids=["unfused", "fused"])
def test_cross_entropy_bf16_logits_under_auto_cast(monkeypatch, fusion):
    """bf16 logits in an O2 scope: cross_entropy is black, so both sides
    upcast to fp32 and return an fp32 loss."""
    monkeypatch.setenv("PT_FUSION_PASSES", "1" if fusion else "0")
    rs = np.random.RandomState(5)
    xb = jnp.asarray((2 * rs.randn(16, 256)).astype(np.float32)).astype(
        jnp.bfloat16)
    labels = rs.randint(0, 256, (16,)).astype(np.int32)
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        jl = JF.cross_entropy(paddle.to_tensor(xb),
                              paddle.to_tensor(labels))
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        tl = PF.cross_entropy(tx, torch.from_numpy(labels))
    assert tl.dtype == torch.float32
    assert np.asarray(jl._value).dtype == np.float32
    np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=1e-6)


def test_llama_unfused_head_rides_the_fusion_flag(monkeypatch):
    """``fused_head_ce=False``: the head's logits go through
    ``cross_entropy``, which with ``PT_FUSION_PASSES=1`` runs the xent
    rows (the plain version here) on both sides."""
    monkeypatch.setenv("PT_FUSION_PASSES", "1")
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False,
                                  fused_head_ce=False))
    tm = LlamaForCausalLM(llama_tiny_config(fused_head_ce=False),
                          device="cpu")
    tm.load_state_dict(params_from_jax(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()}))
    ids = np.random.RandomState(6).randint(0, 512, (2, 16)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    jl, _ = jm(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jl.backward()
    jgrads = params_from_jax({n: np.asarray(p.grad._value)
                              for n, p in jm.named_parameters()})
    ops.reset_launch_counts()
    tl, logits = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    tl.backward()
    assert logits.shape == (2, 16, 512)
    np.testing.assert_allclose(float(tl.detach()),
                               float(np.asarray(jl._value)), rtol=1e-5)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n].numpy(),
                                   atol=1e-4, err_msg=n)
