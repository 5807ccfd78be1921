"""The port's ERNIE-MoE training step against the JAX package's, on the
CPU.

``ernie_moe_tiny_config`` (2 layers, the second MoE with 4 experts, top
2) with the JAX model's weights carried across by
``convert.params_from_jax``:

- fp32 loss, logits and every parameter's gradient, with the default
  routes and with the kernel routes (``PT_MOE_GATHER=pallas``, which
  only the JAX package reads, and ``PT_FUSION_PASSES=1``; the JAX side
  runs its Pallas gather and xent kernels in interpret mode, the port
  the plain versions of its kernels, as on every CPU tensor): loss 1e-5
  relative, logits 1e-5, gradients 1e-4 (XLA's CPU dots and torch's sum
  in other orders, as the Llama training tests).
- One fp32 AdamW ``TrainStep``: the parameters to 1e-6 (the Llama
  tests' ``_assert_step_close``).
- Three O2 steps with ``multi_precision=False`` (bf16 parameters carry
  bf16 moments, the LayerNorm parameters fp32 ones), the bench recipe
  (``auto_cast`` O2 around the forward), kernel routes on both sides:
  losses, every parameter's move and both moments against JAX's (the
  bounds and why in the test's docstring).
- ``fused_adamw`` with bf16 moments against the Pallas ``_adamw_kernel``
  in interpret mode (>= 1024 elements, the Pallas route's condition),
  whose fp32 moments the JAX optimizer rounds back to bf16: p, m and v
  equal up to one bf16 ulp (the fp32 results may differ in the last
  bit, which can move a rounding). Below 1024 elements the JAX wrapper
  computes in the operands' dtypes (bf16 arithmetic, each operation
  rounded) while the port keeps the kernel's fp32 arithmetic; there each
  new moment agrees within 2^-6 of the magnitudes of its two terms
  (``beta·m`` and ``(1-beta)·g`` or ``g²``, which may cancel; four
  bf16 roundings on the JAX side) and p within one bf16 ulp of its
  magnitude plus 2 lr (the update itself may round differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.ernie_moe import ErnieMoEForCausalLM as JaxErnie
from paddle_tpu.models.ernie_moe import \
    ernie_moe_tiny_config as jax_tiny_config
from paddle_tpu.ops.pallas import fused as jfused
from paddle_tpu.ops.pallas import moe_dispatch as jmd

from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (ErnieMoEForCausalLM,
                                     ernie_moe_tiny_config)
from paddle_tpu_torch.ops.fused import fused_adamw
from paddle_tpu_torch.optimizer import AdamW
from test_torch_port_train import LR, WD, _assert_step_close


@pytest.fixture
def kernel_routes(monkeypatch):
    """The JAX package's gather and xent kernel routes (its Pallas
    kernels in interpret mode) and the port's fused xent rows; the
    port's gather has one route on the CPU, the plain version."""
    monkeypatch.setenv("PT_MOE_GATHER", "pallas")
    monkeypatch.setenv("PT_FUSION_PASSES", "1")
    monkeypatch.setattr(jmd, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jfused, "_FORCE_INTERPRET", True)


@pytest.fixture
def default_routes(monkeypatch):
    monkeypatch.delenv("PT_MOE_GATHER", raising=False)
    monkeypatch.delenv("PT_FUSION_PASSES", raising=False)


def _models():
    paddle.seed(0)
    jm = JaxErnie(jax_tiny_config(expert_parallel=False))
    tm = ErnieMoEForCausalLM(ernie_moe_tiny_config(expert_parallel=False),
                             device="cpu")
    tm.load_state_dict(_jax_params(jm))
    return jm, tm


def _jax_params(jm):
    return params_from_jax({n: np.asarray(p._value).astype(np.float32)
                            if np.asarray(p._value).dtype.name == "bfloat16"
                            else np.asarray(p._value)
                            for n, p in jm.named_parameters()})


def _batch(seed=0, b=2, s=32):
    ids = np.random.RandomState(seed).randint(0, 512, (b, s)) \
        .astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _jax_batch(batch):
    return tuple(paddle.to_tensor(a) for a in batch)


def _jax_loss(m, batch):
    return m(*batch)[0]


def _port_loss(m, batch):
    return m(*batch)[0]


def _jax_o2_loss(m, batch):
    with jamp.auto_cast(dtype="bfloat16", level="O2"):
        return m(*batch)[0]


def _port_o2_loss(m, batch):
    with amp.auto_cast(dtype="bfloat16", level="O2"):
        return m(*batch)[0]


def _jax_grads(jm, batch):
    _jax_loss(jm, _jax_batch(batch)).backward()
    return params_from_jax({n: np.asarray(p.grad._value)
                            for n, p in jm.named_parameters()})


@pytest.mark.parametrize("routes", ["default_routes", "kernel_routes"])
def test_loss_logits_and_grads_match_jax(request, routes):
    request.getfixturevalue(routes)
    jm, tm = _models()
    batch = _batch()
    jl, jlogits = jm(*_jax_batch(batch))
    jl.backward()
    jgrads = params_from_jax({n: np.asarray(p.grad._value)
                              for n, p in jm.named_parameters()})
    tl, tlogits = tm(*(torch.from_numpy(a) for a in batch))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()),
                               float(np.asarray(jl._value)), rtol=1e-5)
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits.numpy(),
                               atol=1e-5)
    assert set(n for n, _ in tm.named_parameters()) == set(jgrads)
    for n, p in tm.named_parameters():
        assert torch.isfinite(p.grad).all(), n
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n].numpy(),
                                   atol=1e-4, err_msg=n)


def test_one_adamw_step_matches_jax(default_routes):
    jm, tm = _models()
    batch = _batch(1)
    grads = _jax_grads(jm, batch)
    jopt = joptimizer.AdamW(learning_rate=LR, weight_decay=WD,
                            parameters=jm.parameters())
    JaxTrainStep(jm, _jax_loss, jopt)(_jax_batch(batch))
    topt = AdamW(learning_rate=LR, weight_decay=WD,
                 parameters=tm.parameters())
    TrainStep(tm, _port_loss, topt)(batch)
    want = _jax_params(jm)
    for n, p in tm.named_parameters():
        g = grads[n]
        if n.endswith("qkv_proj.bias"):
            # the key bias's gradient is zero in exact arithmetic (each
            # query's softmax is invariant to a shift of its scores), so
            # both frameworks' values are rounding noise that the first
            # Adam step scales up to lr: hold those entries to the
            # update's bound alone, as _assert_step_close does for
            # gradients below 1e-6
            g = g.clone()
            h = g.numel() // 3
            g[h:2 * h] = 1e-9
        _assert_step_close(p.detach(), want[n], g)


def test_o2_bf16_moment_steps_track_jax(kernel_routes):
    """The bench's recipe: ``amp.decorate`` O2 on the model alone, then
    ``AdamW(multi_precision=False)``, the forward under ``auto_cast``,
    three steps on three batches. Losses within 2e-2 (bf16 rounds at
    other sites in the two frameworks, as in the Llama O2 test). Then
    every parameter and both its moments against JAX's after the steps:

    - each moment within 10% of JAX's in norm (4.1% at most at this
      seed: the bf16 gradients differ by rounding);
    - each parameter's move (after minus before) within 20% of JAX's
      move in norm. A bf16 parameter moves about one bf16 ulp a step,
      so an update that rounds the other way is a whole ulp: the moves
      agree within 10.2% at this seed, 17.5% for the LayerNorm in front
      of the MoE router. The key third of ``qkv_proj.bias`` is left out
      of that norm: its gradient is rounding noise in both frameworks
      (zero in exact arithmetic) that Adam scales to lr, so those
      entries are held to the updates' own bound: each side's three
      steps of at most lr plus the decay, in either direction, and three
      bf16 roundings on each side.

    A no-op or missing update fails both checks: its moves are zero,
    100% away from JAX's nonzero ones, and its moments stay at zero."""
    jm, tm = _models()
    jamp.decorate(jm, level="O2", dtype="bfloat16")
    amp.decorate(tm, level="O2", dtype="bfloat16")
    jopt = joptimizer.AdamW(learning_rate=LR, weight_decay=WD,
                            parameters=jm.parameters(),
                            multi_precision=False)
    topt = AdamW(learning_rate=LR, weight_decay=WD,
                 parameters=tm.parameters(), multi_precision=False)
    before = {n: p.detach().float().clone() for n, p in tm.named_parameters()}
    jstep = JaxTrainStep(jm, _jax_o2_loss, jopt)
    tstep = TrainStep(tm, _port_o2_loss, topt)
    jl, tl = [], []
    for i in range(3):
        batch = _batch(i)
        jl.append(float(np.asarray(
            jstep(_jax_batch(batch))._value.astype(jnp.float32))))
        tl.append(float(tstep(batch)))
    np.testing.assert_allclose(tl, jl, atol=2e-2)
    by_id = {id(p): n for n, p in jm.named_parameters()}
    state = adamw_state_from_jax(jopt.functional_state(), {
        on: by_id[id(p)] for on, p in zip(jopt._param_names,
                                           jopt._param_list)})
    assert topt._step_count == state["step"] == 3
    want = _jax_params(jm)
    for n, p in tm.named_parameters():
        dtype = torch.float32 if ".ln_" in n else torch.bfloat16
        assert p.dtype == dtype, n
        slots = topt._slots[id(p)]
        assert "master" not in slots
        for k in ("moment1", "moment2"):
            got, ref = slots[k], state["slots"][n][k]
            assert got.dtype == ref.dtype == dtype, (n, k)
            assert float((got.float() - ref.float()).norm()) <= \
                0.1 * float(ref.float().norm()), (n, k)
        moved = p.detach().float() - before[n]
        want_moved = want[n].float() - before[n]
        if n.endswith("qkv_proj.bias"):
            h = p.numel() // 3
            noise = slice(h, 2 * h)
            bound = 2 * 3 * LR * (1 + WD * float(before[n].abs().max())) \
                + 2 * 3 * 2.0 ** -9 * before[n][noise].abs()
            assert bool(((moved - want_moved)[noise].abs() <= bound).all())
            moved, want_moved = (torch.cat([a[:h], a[2 * h:]])
                                 for a in (moved, want_moved))
        assert float(want_moved.norm()) > 0, n
        assert float((moved - want_moved).norm()) <= \
            0.2 * float(want_moved.norm()), n


def _adamw_case(n, seed):
    rs = np.random.RandomState(seed)

    def bf16(a):
        return np.asarray(jnp.asarray(a.astype(np.float32)).astype(
            jnp.bfloat16).astype(jnp.float32))
    return (bf16(0.05 * rs.randn(n)), bf16(1e-3 * rs.randn(n)),
            bf16(1e-3 * rs.randn(n)), bf16(1e-6 * rs.rand(n)))


def _port_adamw(p, g, m, v, step):
    tp, tg, tm_, tv = (torch.from_numpy(a).bfloat16() for a in (p, g, m, v))
    fused_adamw(tp, tg, tm_, tv, LR, 0.9, 0.999, 1e-8, WD, step)
    return [t.float().numpy() for t in (tp, tm_, tv)]


def _jax_adamw(p, g, m, v, step):
    out = jfused.fused_adamw(*(jnp.asarray(a).astype(jnp.bfloat16)
                               for a in (p, g, m, v)),
                             LR, 0.9, 0.999, 1e-8, WD, step)
    # the optimizer keeps the slots' declared dtype (_keep_slot_dtypes)
    return [np.asarray(o.astype(jnp.bfloat16).astype(jnp.float32))
            for o in out]


@pytest.mark.parametrize("step", [1, 5])
def test_fused_adamw_bf16_moments_match_pallas(monkeypatch, step):
    monkeypatch.setattr(jfused, "_FORCE_INTERPRET", True)
    case = _adamw_case(3001, step)
    got, want = _port_adamw(*case, step), _jax_adamw(*case, step)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=2.0 ** -8, atol=0)


def test_fused_adamw_bf16_moments_below_1024(monkeypatch):
    """768 elements (``out_proj.bias``): the JAX wrapper's bf16 jnp
    arithmetic against the port's fp32 kernel arithmetic."""
    monkeypatch.setattr(jfused, "_FORCE_INTERPRET", True)
    p, g, m, v = _adamw_case(768, 2)
    (gp, gm, gv), (wp, wm, wv) = _port_adamw(p, g, m, v, 2), \
        _jax_adamw(p, g, m, v, 2)
    assert np.all(np.abs(gm - wm) <= 2.0 ** -6 * (0.9 * np.abs(m)
                                                  + 0.1 * np.abs(g)))
    assert np.all(np.abs(gv - wv) <= 2.0 ** -6 * (0.999 * v + 1e-3 * g * g))
    assert np.all(np.abs(gp - wp) <= 2.0 ** -8 * np.abs(wp) + 2 * LR)
