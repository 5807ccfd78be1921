"""The port's training harness against the JAX package's, on the CPU:
``jit.TrainStep`` (its aux outputs, ``run_steps``, ``lower``),
``jit.EvalStep``, the optimizer's step and learning rate as device
tensors, state loads that keep the tensors a captured graph holds, and
the AdamW plain version over those device scalars.

``llama_tiny`` and the tiny ERNIE-MoE carry the JAX models' weights
through ``convert.params_from_jax``. Tolerances are those of
``test_torch_port_train.py``: losses 1e-4 over several steps,
parameters 1e-6 after a step (``_assert_step_close``, with its
exemption for gradients near eps), fp32 logits 1e-5 (XLA's CPU dots and
torch's sum in other orders). The AdamW plain version is held bit for
bit: its device bias corrections repeat ``_pow_f32``'s products in the
same order."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.jit import EvalStep as JaxEvalStep
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.ernie_moe import ErnieMoEForCausalLM as JaxErnie
from paddle_tpu.models.ernie_moe import \
    ernie_moe_tiny_config as jax_ernie_tiny_config

from paddle_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from paddle_tpu_torch.jit import EvalStep, TrainStep
from paddle_tpu_torch.models import (ErnieMoEForCausalLM,
                                     ernie_moe_tiny_config)
from paddle_tpu_torch.ops.fused import (_pow_f32, _pow_f32_device,
                                        adamw_reference, fused_adamw)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from test_torch_port_train import (LR, WD, _batch, _jax_batch, _jax_params,
                                   _models)


def _aux_loss(m, batch):
    """A loss with aux outputs: a tensor and a constant."""
    loss = m(*batch)[0]
    return loss, loss * loss, None


def _pair(case="untied", loss_fn=_aux_loss, lr=LR):
    jm, tm = _models(case)
    jopt = joptimizer.AdamW(learning_rate=lr, weight_decay=WD,
                            parameters=jm.parameters())
    topt = AdamW(learning_rate=lr, weight_decay=WD,
                 parameters=tm.parameters())
    return (jm, jopt, JaxTrainStep(jm, loss_fn, jopt)), \
        (tm, topt, TrainStep(tm, loss_fn, topt))


def _np(x):
    return np.asarray(x._value) if hasattr(x, "_value") else x.numpy()


# -- TrainStep ---------------------------------------------------------------

def _jax_grads_at(jm, batch):
    """The JAX model's gradients at ``batch`` under the port's names
    (one forward and backward; the gradients are cleared again)."""
    loss = jm(*_jax_batch(batch))[0]
    loss.backward()
    out = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    for p in jm.parameters():
        p.clear_gradient()
    return params_from_jax(out)


def _ill(masks, grads):
    """``_assert_step_close``'s exemption (0 < |g| < 1e-6) accumulated
    over steps: an entry exempt at any step stays exempt."""
    cur = {n: (g != 0) & (g.abs() < 1e-6) for n, g in grads.items()}
    return cur if masks is None else {n: masks[n] | cur[n] for n in cur}


def _assert_steps_close(got, want, ill, n_steps):
    """``_assert_step_close`` after ``n_steps`` steps: 1e-6 (plus 1e-6
    relative) where no step's gradient was near eps; elsewhere the
    updates' own bound, lr plus the decay term a step."""
    d = (got - want).abs()
    assert bool((d <= 1e-6 + 1e-6 * want.abs())[~ill].all())
    assert float(d.max()) <= \
        n_steps * LR * (1 + WD * float(want.abs().max()))


@pytest.mark.parametrize("case", ["untied", "gqa"])
def test_call_returns_aux_as_jax(case):
    """``loss_fn`` returning ``(loss, aux, None)``: both steps return
    ``(loss, aux, None)``, equal to 1e-4 over three steps on three
    batches, and the parameters after them to 1e-6."""
    (jm, _, jstep), (tm, _, tstep) = _pair(case)
    ill = None
    for i in range(3):
        batch = _batch(i)
        ill = _ill(ill, _jax_grads_at(jm, batch))
        jout, tout = jstep(_jax_batch(batch)), tstep(batch)
        assert isinstance(tout, tuple) and len(tout) == len(jout) == 3
        assert tout[2] is None and jout[2] is None
        for a, b in zip(tout[:2], jout[:2]):
            np.testing.assert_allclose(float(a), float(_np(b)), atol=1e-4)
        assert tstep.last_loss == float(tout[0])
    want = _jax_params(jm)
    for n, p in tm.named_parameters():
        _assert_steps_close(p.detach(), want[n], ill[n], 3)


def test_run_steps_matches_jax():
    """``run_steps(batch, 3)`` on both sides: the last loss and its aux
    to 1e-4, the parameters to 1e-6 (gradients near eps at any step
    exempt: their entries come from a twin JAX model stepped by
    ``__call__``), the step counts 3."""
    batch = _batch(0)
    (jm, _, jstep), _ = _pair("untied")
    ill = None
    for _ in range(3):
        ill = _ill(ill, _jax_grads_at(jm, batch))
        jstep(_jax_batch(batch))
    (jm, jopt, jstep), (tm, topt, tstep) = _pair("untied")
    jout = jstep.run_steps(_jax_batch(batch), 3)
    tout = tstep.run_steps(batch, 3)
    assert isinstance(tout, tuple) and len(tout) == len(jout) == 3
    for a, b in zip(tout[:2], jout[:2]):
        np.testing.assert_allclose(float(a), float(_np(b)), atol=1e-4)
    assert tstep.last_loss == float(tout[0])
    assert topt._step_count == int(np.asarray(
        jopt.functional_state()["step"])) == 3
    want = _jax_params(jm)
    for n, p in tm.named_parameters():
        _assert_steps_close(p.detach(), want[n], ill[n], 3)


def test_run_steps_equals_single_calls():
    """n steps through ``run_steps`` and through n calls are the same
    computation on the CPU: bit-equal parameters and last loss."""
    (_, _, _), (ta, _, sa) = _pair("untied", loss_fn=lambda m, b: m(*b)[0])
    (_, _, _), (tb, _, sb) = _pair("untied", loss_fn=lambda m, b: m(*b)[0])
    batch = _batch(1)
    last = sa.run_steps(batch, 3)
    for _ in range(3):
        one = sb(batch)
    assert not isinstance(last, tuple)
    assert torch.equal(last, one)
    for pa, pb in zip(ta.parameters(), tb.parameters()):
        assert torch.equal(pa, pb)


def test_step_and_lr_live_on_the_device():
    """The step count and the learning rate are (1,) int32 / fp32
    tensors on the parameters' device; ``__call__`` and ``run_steps``
    move both them and the host mirror in ``state_dict()``; a scheduler
    step between calls reaches the lr tensor, read once a
    ``run_steps``."""
    _, tm = _models("untied")
    sched = tlr.StepDecay(learning_rate=1e-3, step_size=1, gamma=0.5)
    opt = AdamW(learning_rate=sched, weight_decay=WD,
                parameters=tm.parameters())
    step = TrainStep(tm, lambda m, b: m(*b)[0], opt)
    for t, dtype in ((opt._step_tensor, torch.int32),
                     (opt._lr_tensor, torch.float32)):
        assert t.shape == (1,) and t.dtype == dtype
        assert t.device == next(tm.parameters()).device
    assert int(opt._step_tensor) == 0
    step(_batch(0))
    assert int(opt._step_tensor) == 1 == opt.state_dict()["@step"]
    assert float(opt._lr_tensor) == np.float32(1e-3)
    sched.step()
    step.run_steps(_batch(0), 3)
    assert int(opt._step_tensor) == 4 == opt.state_dict()["@step"]
    assert float(opt._lr_tensor) == np.float32(5e-4)
    sched.step()
    step(_batch(0))
    assert int(opt._step_tensor) == 5 == opt._step_count
    assert float(opt._lr_tensor) == np.float32(2.5e-4)


def test_state_loads_keep_tensor_addresses():
    """``set_state_dict`` and ``load_state`` copy into the slot tensors
    and the step tensor the optimizer holds (a captured graph reads
    those addresses); the values are the loaded ones."""
    (jm, jopt, jstep), (tm, topt, tstep) = _pair(
        "untied", loss_fn=lambda m, b: m(*b)[0])
    tstep(_batch(0))
    ptrs = {(id(p), k): v.data_ptr() for p in tm.parameters()
            for k, v in topt._slots[id(p)].items()}
    step_ptr = topt._step_tensor.data_ptr()
    sd = topt.state_dict()
    tstep(_batch(1))
    topt.set_state_dict({k: (v * 2 if isinstance(v, torch.Tensor) else v)
                         for k, v in sd.items()})
    for n, p in zip(topt._param_names, topt._param_list):
        for k, v in topt._slots[id(p)].items():
            assert v.data_ptr() == ptrs[(id(p), k)]
            assert torch.equal(v, sd[f"{n}.{k}"] * 2)
    assert topt._step_tensor.data_ptr() == step_ptr
    assert int(topt._step_tensor) == 1 == topt._step_count
    for i in range(2):
        jstep(_jax_batch(_batch(i)))
    by_id = {id(p): n for n, p in jm.named_parameters()}
    state = adamw_state_from_jax(jopt.functional_state(), {
        on: by_id[id(p)] for on, p in zip(jopt._param_names,
                                           jopt._param_list)})
    topt.load_state(state, tm.named_parameters())
    for n, p in tm.named_parameters():
        for k, v in topt._slots[id(p)].items():
            assert v.data_ptr() == ptrs[(id(p), k)]
            assert torch.equal(v, state["slots"][n][k])
    assert topt._step_tensor.data_ptr() == step_ptr
    assert int(topt._step_tensor) == 2 == topt._step_count


def test_lower_raises():
    (_, _, _), (_, _, tstep) = _pair("untied")
    with pytest.raises(NotImplementedError, match="A.9"):
        tstep.lower(_batch(0))


def test_ernie_run_steps_matches_jax(monkeypatch):
    """The tiny ERNIE-MoE (fp32, default routes): ``run_steps(batch, 3)``
    with an aux-returning loss against JAX's: the loss and aux to 1e-4,
    every parameter within three updates' bound (lr plus the decay a
    step), the step count 3."""
    monkeypatch.delenv("PT_MOE_GATHER", raising=False)
    monkeypatch.delenv("PT_FUSION_PASSES", raising=False)
    paddle.seed(0)
    jm = JaxErnie(jax_ernie_tiny_config(expert_parallel=False))
    tm = ErnieMoEForCausalLM(ernie_moe_tiny_config(expert_parallel=False),
                             device="cpu")
    tm.load_state_dict(_jax_params(jm))
    jopt = joptimizer.AdamW(learning_rate=LR, weight_decay=WD,
                            parameters=jm.parameters())
    topt = AdamW(learning_rate=LR, weight_decay=WD,
                 parameters=tm.parameters())
    jstep = JaxTrainStep(jm, _aux_loss, jopt)
    tstep = TrainStep(tm, _aux_loss, topt)
    ids = np.random.RandomState(0).randint(0, 512, (2, 32)).astype(np.int32)
    batch = (ids, np.roll(ids, -1, axis=1).astype(np.int32))
    jout = jstep.run_steps(_jax_batch(batch), 3)
    tout = tstep.run_steps(batch, 3)
    assert len(tout) == len(jout) == 3 and tout[2] is None
    for a, b in zip(tout[:2], jout[:2]):
        np.testing.assert_allclose(float(a), float(_np(b)), atol=1e-4)
    assert topt._step_count == 3 == int(topt._step_tensor)
    want = _jax_params(jm)
    for n, p in tm.named_parameters():
        bound = 3 * LR * (1 + WD * float(want[n].abs().max())) + 1e-6
        assert float((p.detach() - want[n]).abs().max()) <= bound, n


# -- EvalStep ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["untied", "gqa"])
def test_eval_step_matches_jax(case):
    """``EvalStep`` with a function of (model, batch) returning a dict:
    the logits to 1e-5, the model back in training mode, no gradient."""
    jm, tm = _models(case)
    ids = _batch(3)[0]

    def jfn(m, b):
        return {"logits": m(b[0]), "n": 4}

    def tfn(m, b):
        assert not m.training and not torch.is_grad_enabled()
        return {"logits": m(b[0]), "n": 4}

    jout = JaxEvalStep(jm, jfn)((paddle.to_tensor(ids),))
    tm.train()
    tout = EvalStep(tm, tfn)((ids,))
    assert tm.training
    assert tout["n"] == 4 and not tout["logits"].requires_grad
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]._value), atol=1e-5)


def test_eval_step_default_fn():
    """The default function is ``model(batch)``."""
    _, tm = _models("untied")
    ids = torch.from_numpy(_batch(4)[0])
    torch.testing.assert_close(EvalStep(tm)(ids), tm(ids), rtol=0, atol=0)


# -- AdamW over device scalars -----------------------------------------------

def _parent_adamw_reference(p, g, m, v, lr, beta1, beta2, eps, weight_decay,
                            step):
    """The plain AdamW before the scalars moved to the device: every
    scalar an fp32 0-dim tensor, the bias corrections from
    ``_pow_f32`` on the host."""
    one = np.float32(1)
    bc1 = float(one - _pow_f32(beta1, step))
    bc2 = float(one - _pow_f32(beta2, step))
    pf, gf, m, v = p.float(), g.float(), m.float(), v.float()
    lr, beta1, beta2, eps, weight_decay, bc1, bc2 = (
        torch.tensor(x, dtype=torch.float32)
        for x in (lr, beta1, beta2, eps, weight_decay, bc1, bc2))
    m_new = beta1 * m + (1 - beta1) * gf
    v_new = beta2 * v + (1 - beta2) * gf * gf
    p_new = pf - lr * ((m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                       + weight_decay * pf)
    return p_new.to(p.dtype), m_new, v_new


@pytest.mark.parametrize("step", [1, 2, 7, 1000])
@pytest.mark.parametrize("beta", [0.9, 0.999, 0.95])
def test_device_pow_is_host_pow(step, beta):
    got = _pow_f32_device(beta, torch.tensor([step], dtype=torch.int32))
    assert got.dtype == torch.float32
    assert got.numpy()[0].tobytes() == _pow_f32(beta, step).tobytes()


DTYPES = [(torch.float32, torch.float32, torch.float32),
          (torch.float32, torch.bfloat16, torch.float32),
          (torch.bfloat16, torch.float32, torch.float32),
          (torch.bfloat16, torch.bfloat16, torch.float32),
          (torch.float32, torch.float32, torch.bfloat16),
          (torch.float32, torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32, torch.bfloat16),
          (torch.bfloat16, torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("step", [1, 2, 7, 1000])
@pytest.mark.parametrize("dtypes", DTYPES,
                         ids=lambda d: "-".join(str(t)[6:] for t in d))
def test_adamw_plain_with_device_scalars_is_the_parents(dtypes, step):
    """The plain version over a (1,) fp32 lr and a (1,) int32 step,
    through ``fused_adamw`` (in place) and directly, bit-equal to the
    parent's host-float arithmetic, for every (p, g, moments) dtype
    combination the kernel takes."""
    pd, gd, md = dtypes
    rs = np.random.RandomState(step)
    n = 1031
    p = torch.from_numpy(0.05 * rs.randn(n).astype(np.float32)).to(pd)
    g = torch.from_numpy(1e-3 * rs.randn(n).astype(np.float32)).to(gd)
    m = torch.from_numpy(1e-3 * rs.randn(n).astype(np.float32)).to(md)
    v = torch.from_numpy(1e-6 * rs.rand(n).astype(np.float32)).to(md)
    hp = (0.9, 0.999, 1e-8, 0.01)
    want = _parent_adamw_reference(p, g, m, v, 3e-4, *hp, step)
    lr_t = torch.tensor([3e-4], dtype=torch.float32)
    step_t = torch.tensor([step], dtype=torch.int32)
    got = adamw_reference(p, g, m, v, lr_t, step_t, *hp)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    kp, km, kv = p.clone(), m.clone(), v.clone()
    fused_adamw(kp, g, km, kv, lr_t, *hp, step_t)
    for a, b in zip((kp, km, kv), want):
        assert torch.equal(a, b.to(a.dtype))


def test_fused_adamw_checks_its_scalars():
    p, g, m, v = (torch.zeros(8) for _ in range(4))
    with pytest.raises(ValueError, match="lr"):
        fused_adamw(p, g, m, v, torch.zeros(1, dtype=torch.float64))
    with pytest.raises(ValueError, match="step"):
        fused_adamw(p, g, m, v, 1e-3, step=torch.ones(2,
                                                      dtype=torch.int32))
