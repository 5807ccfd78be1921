"""The port's Llama training step against the JAX package's, on the CPU.

``llama_tiny`` with the JAX model's weights carried across through
``convert.params_from_jax``, untied, tied, GQA and with a sliding
window of 4 keys: the loss and every
parameter's gradient, one ``TrainStep`` with AdamW, five steps' losses,
a step continued from a JAX optimizer state, and three bf16 O2 steps.
Tolerances: fp32 loss 1e-5 relative and gradients 1e-4 absolute (XLA's
CPU dots and torch's sum in other orders); parameters after a step
1e-6; five steps' losses 1e-4; O2 losses 2e-2 (bf16 rounds at other
sites in the two frameworks, e.g. the attention probabilities)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config

from paddle_tpu_torch import amp, ops
from paddle_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.optimizer import AdamW

CASES = {"untied": {}, "tied": dict(tie_word_embeddings=True),
         "gqa": dict(num_key_value_heads=2),
         "window": dict(sliding_window=4)}
# bench.py's AdamW settings. At step 1 the update is lr*g/(|g| + eps):
# for the rare gradient entries near eps a 1e-9 difference between the
# two frameworks' gradients moves it by a visible fraction of lr, so a
# larger lr would need a looser parameter tolerance than 1e-6
LR, WD = 1e-4, 0.01


def _models(case, dtype=None):
    """The JAX tiny Llama (seed 0) and the port's with its weights."""
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False, **CASES[case]))
    tm = LlamaForCausalLM(llama_tiny_config(**CASES[case]), device="cpu")
    tm.load_state_dict(params_from_jax(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()}))
    return jm, tm


def _batch(seed=0, b=2, s=16):
    ids = np.random.RandomState(seed).randint(0, 512, (b, s)) \
        .astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _jax_loss(m, batch):
    loss, _ = m(*batch)
    return loss


def _port_loss(m, batch):
    loss, _ = m(*batch)
    return loss


def _jax_step(jm, multi_precision=False):
    opt = joptimizer.AdamW(learning_rate=LR, weight_decay=WD,
                           parameters=jm.parameters(),
                           multi_precision=multi_precision)
    return opt, JaxTrainStep(jm, _jax_loss, opt)


def _port_step(tm, multi_precision=False):
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=tm.parameters(), multi_precision=multi_precision)
    return opt, TrainStep(tm, _port_loss, opt)


def _jax_batch(batch):
    return tuple(paddle.to_tensor(a) for a in batch)


def _jax_params(jm):
    return params_from_jax({n: np.asarray(p._value)
                            for n, p in jm.named_parameters()})


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case):
    jm, tm = _models(case)
    batch = _batch()
    jl = _jax_loss(jm, _jax_batch(batch))
    jl.backward()
    jgrads = params_from_jax({n: np.asarray(p.grad._value)
                              for n, p in jm.named_parameters()})
    tl = _port_loss(tm, tuple(torch.from_numpy(a) for a in batch))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()),
                               float(np.asarray(jl._value)), rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(jgrads)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n].numpy(),
                                   atol=1e-4, err_msg=n)


@pytest.mark.parametrize("case", list(CASES))
def test_every_parameter_gets_a_finite_grad(case):
    _, tm = _models(case)
    batch = tuple(torch.from_numpy(a) for a in _batch(1))
    _port_loss(tm, batch).backward()
    for n, p in tm.named_parameters():
        assert p.grad is not None, n
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, n


def _jax_grads(jm, batch):
    _jax_loss(jm, _jax_batch(batch)).backward()
    return params_from_jax({n: np.asarray(p.grad._value)
                            for n, p in jm.named_parameters()})


def _assert_step_close(got, want, grads):
    """Parameters after an AdamW step equal to 1e-6 (plus 1e-6 relative:
    the N(0, 1) embedding entries reach ~4, where 1e-6 is two fp32
    ulps), except where the gradient is nonzero but within 100x of eps
    (0 < |g| < 1e-6; about 0.05% of the entries, and 12% with a tied
    head, whose embedding rows get the vocab softmax's tiny gradient):
    there the step-1 update lr*g/(|g| + eps) moves by
    lr*eps*dg/(|g| + eps)^2, which turns the frameworks' ~2e-8
    gradient differences into more than 1e-6, so only the update's own
    bound (lr plus the decay term) holds."""
    d = (got - want).abs()
    ill = (grads != 0) & (grads.abs() < 1e-6)
    assert bool((d <= 1e-6 + 1e-6 * want.abs())[~ill].all())
    assert float(d.max()) <= LR * (1 + WD * float(want.abs().max()))


@pytest.mark.parametrize("case", list(CASES))
def test_one_adamw_step_matches_jax(case):
    jm, tm = _models(case)
    batch = _batch()
    grads = _jax_grads(jm, batch)
    _, jstep = _jax_step(jm)
    _, tstep = _port_step(tm)
    jstep(_jax_batch(batch))
    tstep(batch)
    want = _jax_params(jm)
    for n, p in tm.named_parameters():
        _assert_step_close(p.detach(), want[n], grads[n])


@pytest.mark.parametrize("case", list(CASES))
def test_five_step_losses_track_jax(case):
    jm, tm = _models(case)
    _, jstep = _jax_step(jm)
    _, tstep = _port_step(tm)
    batch = _batch()
    jl, tl = [], []
    for _ in range(5):
        jl.append(float(np.asarray(jstep(_jax_batch(batch))._value)))
        tl.append(float(tstep(batch)))
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    assert tl[-1] < tl[0]


def _decorate_jax(jm, opt):
    return jamp.decorate(jm, opt, level="O2", dtype="bfloat16")


@pytest.mark.parametrize("o2", [False, True], ids=["fp32", "o2"])
def test_continue_from_jax_optimizer_state(o2):
    """Two JAX steps; the port takes over the JAX weights and AdamW state
    (moments, fp32 masters under O2, the step count) and runs the third
    step beside the JAX one. The carried state is exact. fp32: the
    third step's moments and parameters match. O2: bf16 gradients that
    cancel to ~1e-5 differ in sign between the frameworks, so a master
    entry is only held to the bound of one update (lr plus decay); each
    master's step (after minus before) is within 10% of the JAX step in
    norm (5% at most at this seed), each bf16 parameter is its master
    rounded, and the third step's loss is within the O2 loss
    tolerance."""
    jm, _ = _models("untied")
    jopt, jstep = _jax_step(jm, multi_precision=o2)
    if o2:
        jm, jopt = _decorate_jax(jm, jopt)
    for i in range(2):
        jstep(_jax_batch(_batch(i)))
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    if o2:
        amp.decorate(tm)
    tm.load_state_dict(_jax_params(jm))
    topt, tstep = _port_step(tm, multi_precision=o2)
    by_id = {id(p): n for n, p in jm.named_parameters()}
    names = {on: by_id[id(p)]
             for on, p in zip(jopt._param_names, jopt._param_list)}
    state = adamw_state_from_jax(jopt.functional_state(), names)
    assert state["step"] == 2
    assert all(("master" in s) == o2 for s in state["slots"].values())
    topt.load_state(state, tm.named_parameters())
    carried = adamw_state_from_jax(jopt.functional_state(), names)
    for n, p in tm.named_parameters():
        for k, v in carried["slots"][n].items():
            torch.testing.assert_close(topt._slots[id(p)][k], v, rtol=0,
                                       atol=0)
    grads = None if o2 else _jax_grads(jm, _batch(2))
    jl = float(np.asarray(jstep(_jax_batch(_batch(2)))._value
                          .astype(jnp.float32)))
    tl = float(tstep(_batch(2)))
    want = _jax_params(jm)
    wstate = adamw_state_from_jax(jopt.functional_state(), names)
    assert topt._step_count == wstate["step"] == 3
    np.testing.assert_allclose(tl, jl, atol=2e-2 if o2 else 1e-5)
    for n, p in tm.named_parameters():
        slots = topt._slots[id(p)]
        if o2:
            before = carried["slots"][n]["master"]
            want_master = wstate["slots"][n]["master"]
            d = (slots["master"] - want_master).abs()
            bound = LR * (1 + WD * float(slots["master"].abs().max()))
            assert float(d.max()) <= 2 * bound, n
            # the master moved as JAX's did, and the bf16 parameter is
            # the master rounded
            moved, want_moved = slots["master"] - before, want_master - before
            assert float((moved - want_moved).norm()) <= \
                0.1 * float(want_moved.norm()), n
            assert torch.equal(p.detach(), slots["master"].to(p.dtype)), n
            continue
        for k in ("moment1", "moment2"):
            np.testing.assert_allclose(
                slots[k].numpy(), wstate["slots"][n][k].numpy(),
                rtol=1e-4, atol=1e-9, err_msg=f"{n}.{k}")
        _assert_step_close(p.detach(), want[n], grads[n])


def test_o2_bf16_losses_track_jax():
    """bench.py's recipe at tiny size: AdamW(multi_precision) and
    amp.decorate O2 in bf16 on both sides, three steps."""
    jm, tm = _models("untied")
    jopt, jstep = _jax_step(jm, multi_precision=True)
    _decorate_jax(jm, jopt)
    topt, tstep = _port_step(tm, multi_precision=True)
    amp.decorate(tm, topt, level="O2", dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert tm.rope_cos.dtype == torch.float32
    jl, tl = [], []
    for i in range(3):
        batch = _batch(i)
        jl.append(float(np.asarray(
            jstep(_jax_batch(batch))._value.astype(jnp.float32))))
        tl.append(float(tstep(batch)))
    np.testing.assert_allclose(tl, jl, atol=2e-2)
    masters = [s["master"] for s in topt._slots.values()]
    assert len(masters) == len(list(tm.parameters()))
    assert all(m.dtype == torch.float32 for m in masters)
    for p in tm.parameters():
        assert torch.equal(p.detach(),
                           topt._slots[id(p)]["master"].to(p.dtype))


def test_plain_head_matches_fused_head():
    """``fused_head_ce=False``: the logits head and its mean CE give the
    fused head's loss and the (b, s, vocab) logits."""
    _, tm = _models("untied")
    ids, labels = (torch.from_numpy(a) for a in _batch())
    fused, none = tm(ids, labels)
    assert none is None
    tm.config.fused_head_ce = False
    plain, logits = tm(ids, labels)
    assert logits.shape == (2, 16, 512)
    np.testing.assert_allclose(float(plain.detach()),
                               float(fused.detach()), rtol=1e-6)
    torch.testing.assert_close(tm(ids), logits)


def test_train_step_follows_the_model_device(monkeypatch):
    """On a GPU-less box the step, the optimizer states and the batch
    stay on the model's (CPU) device; nothing picks the GPU or moves to
    the CPU on its own. The step counts no kernel launch there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = _models("gqa")
    opt, step = _port_step(tm)
    ops.reset_launch_counts()
    loss = step(_batch())
    assert loss.device.type == "cpu" and torch.isfinite(loss)
    assert all(p.grad is None for p in tm.parameters())
    for s in opt._slots.values():
        assert all(v.device.type == "cpu" for v in s.values())
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LlamaForCausalLM(llama_tiny_config())


def test_flops_per_token_matches_jax():
    jm, tm = _models("untied")
    assert tm.flops_per_token(16) == jm.flops_per_token(16)
    assert tm.num_params() == jm.num_params()
