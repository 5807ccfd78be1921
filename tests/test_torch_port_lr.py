"""The port's LR schedulers, gradient clipping and optimizer state
against the JAX package's, on the CPU.

- All 17 subclasses of ``LRScheduler`` give JAX's ``lr`` sequence over
  50 steps, value for value (the port's ``optimizer/lr.py`` is a copy of
  the JAX module in Python floats), and their ``state_dict`` /
  ``set_state_dict`` round trips continue as JAX's do.
- ``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``,
  ``nn.utils.clip_grad_norm_`` and ``clip_grad_value_`` give JAX's
  gradients on the same inputs within 1e-6 (sums in another order);
  ``parameters_to_vector`` / ``vector_to_parameters`` likewise.
- AdamW on ``llama_tiny`` under a scheduler and ``ClipGradByGlobalNorm``
  against JAX's: the learning rates, the parameters after the first
  step (1e-6, ``tests/test_torch_port_train.py``'s rule) and four steps'
  losses (1e-4); the optimizer's ``state_dict`` carries the scheduler's
  state, and a round trip continues bit for bit."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.nn import utils as jutils
from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import optimizer as toptimizer
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.nn import utils as tutils
from paddle_tpu_torch.optimizer import lr as tlr


def _sched(mod, name):
    """One instance of each scheduler class of ``mod``, with arguments
    that reach every branch of its ``get_lr`` within 50 steps."""
    make = {
        "NoamDecay": lambda: mod.NoamDecay(64, 10, learning_rate=1.0),
        "PiecewiseDecay": lambda: mod.PiecewiseDecay(
            [5, 20, 35], [0.1, 0.05, 0.01, 0.001]),
        "NaturalExpDecay": lambda: mod.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lambda: mod.InverseTimeDecay(0.5, 0.1),
        "PolynomialDecay": lambda: mod.PolynomialDecay(
            0.5, 20, end_lr=0.01, power=2.0, cycle=True),
        "LinearWarmup": lambda: mod.LinearWarmup(
            mod.CosineAnnealingDecay(0.5, T_max=30), 10, 0.0, 0.5),
        "ExponentialDecay": lambda: mod.ExponentialDecay(0.5, 0.9),
        "MultiStepDecay": lambda: mod.MultiStepDecay(0.5, [10, 25, 40],
                                                     gamma=0.5),
        "StepDecay": lambda: mod.StepDecay(0.5, 7, gamma=0.5),
        "LambdaDecay": lambda: mod.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "ReduceOnPlateau": lambda: mod.ReduceOnPlateau(
            0.5, patience=2, cooldown=1, factor=0.5),
        "CosineAnnealingDecay": lambda: mod.CosineAnnealingDecay(
            0.5, T_max=30, eta_min=0.01),
        "MultiplicativeDecay": lambda: mod.MultiplicativeDecay(
            0.5, lambda e: 0.97),
        "OneCycleLR": lambda: mod.OneCycleLR(1.0, 50),
        "CyclicLR": lambda: mod.CyclicLR(0.1, 1.0, step_size_up=7,
                                         mode="triangular2"),
        "LinearLR": lambda: mod.LinearLR(0.5, 30, start_factor=0.2),
        "CosineAnnealingWarmRestarts": lambda: mod.CosineAnnealingWarmRestarts(
            0.5, T_0=5, T_mult=2, eta_min=0.01),
    }
    return make[name]()


NAMES = sorted(c.__name__ for c in vars(jlr).values()
               if isinstance(c, type) and issubclass(c, jlr.LRScheduler)
               and c is not jlr.LRScheduler)
# ReduceOnPlateau's metric: falls, then plateaus with small bumps
METRICS = [1.0 - 0.05 * i for i in range(10)] \
    + [0.5 + 0.01 * (i % 3) for i in range(40)]


def _run(sched, steps, start=0):
    out = []
    for i in range(start, start + steps):
        if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
            sched.step(METRICS[i])
        else:
            sched.step()
        out.append(sched())
    return out


def test_every_scheduler_is_ported():
    assert len(NAMES) == 17
    ported = sorted(c.__name__ for c in vars(tlr).values()
                    if isinstance(c, type)
                    and issubclass(c, tlr.LRScheduler)
                    and c is not tlr.LRScheduler)
    assert ported == NAMES
    assert sorted(tlr.__all__) == sorted(jlr.__all__)


@pytest.mark.parametrize("name", NAMES)
def test_scheduler_lr_sequence_matches_jax(name):
    js, ts = _sched(jlr, name), _sched(tlr, name)
    assert ts() == js()
    want = _run(js, 50)
    got = _run(ts, 50)
    assert got == want
    assert len(set(want)) > 1, "the schedule never moved"


@pytest.mark.parametrize("name", NAMES)
def test_scheduler_state_dict_round_trip_matches_jax(name):
    """After 20 steps the state dicts agree; a fresh scheduler given
    that state continues as the JAX one given JAX's state does (and as
    the uninterrupted one, except where the JAX state leaves a value
    out, e.g. ``MultiplicativeDecay``'s running product)."""
    js, ts = _sched(jlr, name), _sched(tlr, name)
    _run(js, 20)
    _run(ts, 20)
    jsd, tsd = js.state_dict(), ts.state_dict()
    assert tsd == jsd
    jb, tb = _sched(jlr, name), _sched(tlr, name)
    jb.set_state_dict(jsd)
    tb.set_state_dict(tsd)
    assert tb() == jb()
    assert _run(tb, 30, start=20) == _run(jb, 30, start=20)
    assert _run(ts, 30, start=20) == _run(js, 30, start=20)


def _grads(rs):
    return {"a": rs.randn(4, 5).astype(np.float32) * 3,
            "b": rs.randn(7).astype(np.float32) * 0.1,
            "c": rs.randn(3, 3, 2).astype(np.float32) * 2}


CLIPS = {"value": ("ClipGradByValue", (0.5,)),
         "value_min": ("ClipGradByValue", (0.5, -0.2)),
         "norm": ("ClipGradByNorm", (1.0,)),
         "norm_loose": ("ClipGradByNorm", (100.0,)),
         "global": ("ClipGradByGlobalNorm", (1.0,)),
         "global_loose": ("ClipGradByGlobalNorm", (1e3,))}


@pytest.mark.parametrize("case", list(CLIPS))
def test_clip_classes_match_jax(case):
    name, args = CLIPS[case]
    g = _grads(np.random.RandomState(0))
    want = getattr(joptimizer, name)(*args).apply(
        {k: jnp.asarray(v) for k, v in g.items()})
    got = getattr(toptimizer, name)(*args).apply(
        {k: torch.from_numpy(v) for k, v in g.items()})
    assert getattr(pnn, name) is getattr(toptimizer, name)
    for k in g:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, err_msg=k)
    if case == "global":         # the clip did clip: global norm 1
        norm = math.sqrt(sum(float((v ** 2).sum()) for v in got.values()))
        assert norm == pytest.approx(1.0, rel=1e-6)


def _param_pairs(seed=0):
    """The same parameters with the same gradients, JAX and port."""
    g = _grads(np.random.RandomState(seed))
    jps, tps = [], []
    for v in g.values():
        p = paddle.to_tensor(np.ones_like(v), stop_gradient=False)
        (p * paddle.to_tensor(v)).sum().backward()
        jps.append(p)
        t = torch.nn.Parameter(torch.ones(v.shape))
        t.grad = torch.from_numpy(v.copy())
        tps.append(t)
    return jps, tps


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
@pytest.mark.parametrize("max_norm", [1.0, 1e4])
def test_clip_grad_norm_matches_jax(norm_type, max_norm):
    jps, tps = _param_pairs()
    jt = jutils.clip_grad_norm_(jps, max_norm, norm_type=norm_type)
    tt = tutils.clip_grad_norm_(tps, max_norm, norm_type=norm_type)
    np.testing.assert_allclose(float(tt), float(np.asarray(jt._value)),
                               rtol=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(),
                                   atol=1e-6)


def test_clip_grad_value_and_vector_round_trip_match_jax():
    jps, tps = _param_pairs(1)
    jutils.clip_grad_value_(jps, 0.3)
    tutils.clip_grad_value_(tps, 0.3)
    for jp, tp in zip(jps, tps):
        np.testing.assert_array_equal(tp.grad.numpy(), jp.grad.numpy())
    jv = jutils.parameters_to_vector(jps)
    tv = tutils.parameters_to_vector(tps)
    np.testing.assert_array_equal(tv.detach().numpy(), jv.numpy())
    vec = np.arange(tv.numel(), dtype=np.float32)
    jutils.vector_to_parameters(paddle.to_tensor(vec), jps)
    tutils.vector_to_parameters(torch.from_numpy(vec), tps)
    for jp, tp in zip(jps, tps):
        np.testing.assert_array_equal(tp.detach().numpy(), jp.numpy())
    with pytest.raises(ValueError, match="elements but parameters need"):
        tutils.vector_to_parameters(torch.zeros(5), tps)
    total = tutils.clip_grad_norm_([torch.nn.Parameter(torch.ones(2))], 1.0)
    assert float(total) == 0.0          # no gradient: nothing to clip


LR0, WD = 1e-3, 0.01


def _jax_sched():
    return jlr.LinearWarmup(jlr.CosineAnnealingDecay(LR0, T_max=10), 2,
                            1e-4, LR0)


def _port_sched():
    return tlr.LinearWarmup(tlr.CosineAnnealingDecay(LR0, T_max=10), 2,
                            1e-4, LR0)


def _models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    tm.load_state_dict(params_from_jax(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()}))
    return jm, tm


def _batch(seed):
    ids = np.random.RandomState(seed).randint(0, 512, (2, 16)) \
        .astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _loss(m, batch):
    loss, _ = m(*batch)
    return loss


def _port_parts(tm):
    sched = _port_sched()
    opt = toptimizer.AdamW(learning_rate=sched, weight_decay=WD,
                           parameters=tm.parameters(),
                           grad_clip=pnn.ClipGradByGlobalNorm(0.5))
    return sched, opt, TrainStep(tm, _loss, opt)


def _steppers(jm, tm):
    jsched = _jax_sched()
    jopt = joptimizer.AdamW(learning_rate=jsched, weight_decay=WD,
                            parameters=jm.parameters(),
                            grad_clip=joptimizer.ClipGradByGlobalNorm(0.5))
    return (jsched, jopt, JaxTrainStep(jm, _loss, jopt), *_port_parts(tm))


def test_adamw_under_a_scheduler_and_global_clip_matches_jax():
    jm, tm = _models()
    batch = _batch(0)
    _loss(jm, tuple(paddle.to_tensor(a) for a in batch)).backward()
    grads = params_from_jax({n: np.asarray(p.grad._value)
                             for n, p in jm.named_parameters()})
    jm.clear_gradients()
    gnorm = math.sqrt(sum(float((g.double() ** 2).sum())
                          for g in grads.values()))
    assert gnorm > 0.5                      # the clip scales this step
    jsched, jopt, jstep, tsched, topt, tstep = _steppers(jm, tm)
    jlosses, tlosses = [], []
    for i in range(4):
        assert topt.get_lr() == jopt.get_lr()
        lr = topt.get_lr()
        jlosses.append(float(np.asarray(jstep(tuple(
            paddle.to_tensor(a) for a in _batch(i)))._value)))
        tlosses.append(float(tstep(_batch(i))))
        if i == 0:
            want = params_from_jax({n: np.asarray(p._value)
                                    for n, p in jm.named_parameters()})
            for n, p in tm.named_parameters():
                d = (p.detach() - want[n]).abs()
                ill = (grads[n] != 0) & (grads[n].abs() * 0.5 / gnorm
                                         < 1e-6)
                assert bool((d <= 1e-6 + 1e-6 * want[n].abs())[~ill].all())
                assert float(d.max()) <= lr * (
                    1 + WD * float(want[n].abs().max())), n
        jsched.step()
        tsched.step()
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4)


def test_optimizer_state_dict_carries_the_scheduler():
    """``state_dict`` holds the slots as ``<name>.<slot>``, ``@step`` and
    the scheduler's state (JAX's layout); a fresh optimizer and scheduler
    given it continue bit for bit; ``set_lr`` refuses under a
    scheduler, as in JAX."""
    _, tm = _models()
    tsched, topt, tstep = _port_parts(tm)
    for i in range(2):
        tstep(_batch(i))
        tsched.step()
    sd = topt.state_dict()
    assert sd["@step"] == 2
    assert sd["LR_Scheduler"] == tsched.state_dict()
    assert set(sd) == {"@step", "LR_Scheduler"} | {
        f"param_{i}.{k}" for i in range(len(list(tm.parameters())))
        for k in ("moment1", "moment2")}
    tm2 = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    tm2.load_state_dict(tm.state_dict())
    sched2, opt2, step2 = _port_parts(tm2)
    opt2.set_state_dict(sd)
    assert opt2.get_lr() == topt.get_lr() != LR0
    assert opt2._step_count == 2
    l1, l2 = tstep(_batch(5)), step2(_batch(5))
    assert torch.equal(l1, l2)
    for p, q in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(p, q)
    for opt in (topt, joptimizer.AdamW(learning_rate=_jax_sched(),
                                       parameters=_models()[0].parameters())):
        with pytest.raises(RuntimeError, match="cannot set_lr"):
            opt.set_lr(0.1)
    plain = toptimizer.AdamW(learning_rate=0.1, parameters=tm.parameters())
    plain.set_lr(0.2)
    assert plain.get_lr() == 0.2
    plain.set_lr_scheduler(tlr.StepDecay(0.3, 2))
    assert plain.get_lr() == 0.3

