"""The port's stacked Llama trunk against the JAX package's, on the CPU.

``scan_layers=True`` builds ``LlamaDecoderStack``: stacked (L, ...)
parameters under JAX's names, one ``unbind(0)`` a forward, the
prototype layer run on each slice, and per-layer recompute ("full":
``checkpoint``; "selective": JAX's ``dots_with_no_batch_dims_saveable``
as a ``CheckpointPolicy`` that saves the linear products). On
``llama_tiny`` with the JAX weights carried across through
``convert.params_from_jax``:

- loss and every gradient against JAX's stacked trunk with the same
  recompute setting (none, full, selective; MHA, GQA, tied head), at
  the tolerances of ``tests/test_torch_port_train.py``: loss 1e-5
  relative, gradients 1e-4 absolute; ``pipeline_parallel=True`` runs the
  stack as one stage, as JAX does without a mesh;
- one ``TrainStep`` (parameters 1e-6, as that file holds them) and five
  steps' losses (1e-4), and a step continued from a JAX AdamW state
  carried across under the stacked names;
- stacked == unstacked in the port, and the three recompute settings,
  bit for bit on the CPU (a recompute repeats the same operations on
  the same inputs);
- the memory the forward leaves for the backward: none > selective >
  full;
- the config's JAX defaults and checks, the refusals, the stacked norm
  weights at 1 after ``init_weights``, and the convert traps (a square
  stacked projection loaded untransposed loads without error and is
  caught only by the parity check, which this file shows fails)."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config

from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import adamw_state_from_jax, params_from_jax
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama_tiny_config)
from paddle_tpu_torch.models.llama import (LlamaDecoderLayer,
                                           LlamaDecoderStack)
from paddle_tpu_torch.optimizer import AdamW

CASES = {"mha": {}, "gqa": dict(num_key_value_heads=2),
         "tied": dict(tie_word_embeddings=True)}
RECOMPUTE = {"none": dict(recompute=False),
             "full": dict(recompute=True, recompute_granularity="full"),
             "selective": dict(recompute=True,
                               recompute_granularity="selective")}
LR, WD = 1e-4, 0.01            # bench.py's AdamW settings


def _kw(case, rc, **more):
    return {"scan_layers": True, **CASES[case], **RECOMPUTE[rc], **more}


def _models(case="mha", rc="none", **more):
    """The JAX stacked tiny Llama (seed 0) and the port's with its
    weights."""
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False,
                                  **_kw(case, rc, **more)))
    tm = LlamaForCausalLM(llama_tiny_config(**_kw(case, rc, **more)),
                          device="cpu")
    tm.load_state_dict(params_from_jax(_jax_named(jm)))
    return jm, tm


def _jax_named(jm, grads=False):
    return {n: np.asarray((p.grad if grads else p)._value)
            for n, p in jm.named_parameters()}


def _batch(seed=0, b=2, s=16):
    ids = np.random.RandomState(seed).randint(0, 512, (b, s)) \
        .astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _torch_batch(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _jax_batch(batch):
    return tuple(paddle.to_tensor(a) for a in batch)


def _loss(m, batch):
    loss, _ = m(*batch)
    return loss


def _port_grads(tm, batch):
    tm.zero_grad(set_to_none=True)
    loss = _loss(tm, _torch_batch(batch))
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in tm.named_parameters()}


def _check_against_jax(jm, tm):
    batch = _batch()
    jl = _loss(jm, _jax_batch(batch))
    jl.backward()
    jgrads = params_from_jax(_jax_named(jm, grads=True))
    tl, tgrads = _port_grads(tm, batch)
    np.testing.assert_allclose(float(tl), float(np.asarray(jl._value)),
                               rtol=1e-5)
    assert set(tgrads) == set(jgrads)
    for n, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n].numpy(), atol=1e-4,
                                   err_msg=n)


@pytest.mark.parametrize("rc", list(RECOMPUTE))
@pytest.mark.parametrize("case", list(CASES))
def test_stacked_loss_and_grads_match_jax(case, rc):
    jm, tm = _models(case, rc)
    assert isinstance(tm.llama.layers, LlamaDecoderStack)
    _check_against_jax(jm, tm)


def test_pipeline_parallel_runs_the_stack_as_one_stage():
    jm, tm = _models("mha", "full", pipeline_parallel=True,
                     scan_layers=False)
    assert isinstance(tm.llama.layers, LlamaDecoderStack)
    _check_against_jax(jm, tm)


def test_stacked_parameter_names_and_shapes_are_jax_layout():
    jm, tm = _models("gqa")
    want = {n: tuple(np.asarray(p._value).shape)
            for n, p in jm.named_parameters()}
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert list(got) == list(want)
    for n, shape in want.items():
        if n.endswith("proj__weight") or n == "lm_head.weight":
            shape = shape[:-2] + shape[:-3:-1]   # JAX (.., in, out)
        assert got[n] == shape, n
    assert got["llama.layers.self_attn__k_proj__weight"] == (2, 64, 128)


def _jax_step(jm):
    opt = joptimizer.AdamW(learning_rate=LR, weight_decay=WD,
                           parameters=jm.parameters(),
                           multi_precision=False)
    return opt, JaxTrainStep(jm, _loss, opt)


def _port_step(tm):
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=tm.parameters(), multi_precision=False)
    return opt, TrainStep(tm, _loss, opt)


def _assert_step_close(got, want, grads):
    """``tests/test_torch_port_train.py``'s rule: parameters after a step
    within 1e-6 (+1e-6 relative), except entries whose gradient is
    nonzero below 1e-6, where step 1's lr*g/(|g| + eps) amplifies the
    frameworks' ~1e-9 gradient differences; those are held to the
    update's own bound."""
    d = (got - want).abs()
    ill = (grads != 0) & (grads.abs() < 1e-6)
    assert bool((d <= 1e-6 + 1e-6 * want.abs())[~ill].all())
    assert float(d.max()) <= LR * (1 + WD * float(want.abs().max()))


@pytest.mark.parametrize("rc", list(RECOMPUTE))
def test_one_train_step_matches_jax(rc):
    jm, tm = _models("mha", rc)
    batch = _batch()
    jl = _loss(jm, _jax_batch(batch))
    jl.backward()
    grads = params_from_jax(_jax_named(jm, grads=True))
    jm.clear_gradients()
    _, jstep = _jax_step(jm)
    _, tstep = _port_step(tm)
    jstep(_jax_batch(batch))
    tstep(batch)
    want = params_from_jax(_jax_named(jm))
    for n, p in tm.named_parameters():
        _assert_step_close(p.detach(), want[n], grads[n])


@pytest.mark.parametrize("rc", list(RECOMPUTE))
def test_five_step_losses_track_jax(rc):
    jm, tm = _models("gqa", rc)
    _, jstep = _jax_step(jm)
    _, tstep = _port_step(tm)
    batch = _batch()
    jl, tl = [], []
    for _ in range(5):
        jl.append(float(np.asarray(jstep(_jax_batch(batch))._value)))
        tl.append(float(tstep(batch)))
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    assert tl[-1] < tl[0]


def test_step_continued_from_a_jax_state_under_stacked_names():
    """Two JAX steps; the port takes the weights and the AdamW state
    (moments carried across ``adamw_state_from_jax``, stacked linear
    moments transposed like their weights) and runs the third step
    beside JAX's."""
    jm, _ = _models("mha", "selective")
    jopt, jstep = _jax_step(jm)
    for i in range(2):
        jstep(_jax_batch(_batch(i)))
    tm = LlamaForCausalLM(llama_tiny_config(**_kw("mha", "selective")),
                          device="cpu")
    tm.load_state_dict(params_from_jax(_jax_named(jm)))
    topt, tstep = _port_step(tm)
    by_id = {id(p): n for n, p in jm.named_parameters()}
    names = {on: by_id[id(p)]
             for on, p in zip(jopt._param_names, jopt._param_list)}
    topt.load_state(adamw_state_from_jax(jopt.functional_state(), names),
                    tm.named_parameters())
    m1 = topt._slots[id(tm.llama.layers.self_attn__q_proj__weight)]
    assert m1["moment1"].shape == (2, 128, 128)
    _ = _loss(jm, _jax_batch(_batch(2)))
    _.backward()
    grads = params_from_jax(_jax_named(jm, grads=True))
    jm.clear_gradients()
    jstep(_jax_batch(_batch(2)))
    tstep(_batch(2))
    want = params_from_jax(_jax_named(jm))
    wstate = adamw_state_from_jax(jopt.functional_state(), names)
    for n, p in tm.named_parameters():
        _assert_step_close(p.detach(), want[n], grads[n])
        for k in ("moment1", "moment2"):
            np.testing.assert_allclose(
                topt._slots[id(p)][k].numpy(),
                wstate["slots"][n][k].numpy(), rtol=1e-4, atol=1e-9,
                err_msg=f"{n}.{k}")


def _unstacked_from(tm_stacked, case):
    """The port's unstacked model on the stacked model's weights."""
    um = LlamaForCausalLM(llama_tiny_config(**CASES[case]), device="cpu")
    sd = {}
    for n, p in tm_stacked.state_dict().items():
        if not n.startswith("llama.layers."):
            sd[n] = p
            continue
        rest = n[len("llama.layers."):].replace("__", ".")
        for i, w in enumerate(p.unbind(0)):
            sd[f"llama.layers.{i}.{rest}"] = w.clone()
    um.load_state_dict(sd)
    return um


def _restack(grads, L):
    """Unstacked per-layer gradients under the stacked names."""
    out, per = {}, {}
    for n, g in grads.items():
        if not n.startswith("llama.layers."):
            out[n] = g
            continue
        i, rest = n[len("llama.layers."):].split(".", 1)
        per.setdefault(rest.replace(".", "__"), {})[int(i)] = g
    for rest, gs in per.items():
        out[f"llama.layers.{rest}"] = torch.stack([gs[i] for i in range(L)])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_stacked_equals_unstacked_and_recompute_is_bitwise(case):
    """On the same weights the stacked trunk gives the unstacked model's
    loss and gradients bit for bit, and so does each recompute setting:
    the stack runs the same layer on slices of the same values, and a
    recompute repeats the same operations on the same inputs."""
    _, tm = _models(case, "none")
    batch = _batch(3)
    ref_loss, ref = _port_grads(_unstacked_from(tm, case), batch)
    ref = _restack(ref, tm.config.num_hidden_layers)
    for rc in RECOMPUTE:
        rm = LlamaForCausalLM(llama_tiny_config(**_kw(case, rc)),
                              device="cpu")
        rm.load_state_dict(tm.state_dict())
        loss, grads = _port_grads(rm, batch)
        assert torch.equal(loss, ref_loss), rc
        assert set(grads) == set(ref)
        for n, g in grads.items():
            assert torch.equal(g, ref[n]), (rc, n)


def test_one_unbind_per_stack_and_no_per_layer_select():
    """The forward slices each stack once (``UnbindBackward``: one
    ``stack`` in the backward); no stacked weight is indexed per layer
    (a ``SelectBackward`` would give each layer a zero-filled (L, ...)
    gradient)."""
    _, tm = _models("mha", "selective")
    loss = _loss(tm, _torch_batch(_batch()))
    seen, todo, names = set(), [loss.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    n_stacks = sum(1 for n, _ in tm.named_parameters()
                   if n.startswith("llama.layers."))
    assert names.count("UnbindBackward0") == n_stacks == 9
    assert "SelectBackward0" not in names


class _LiveStorages(TorchDispatchMode):
    """Weak references to the storage of every tensor an operation
    makes inside the mode."""

    def __init__(self):
        super().__init__()
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                self.refs.setdefault(s.data_ptr(), (StorageWeakRef(s),
                                                    s.nbytes()))
        return out


def _held_bytes(rc):
    """Bytes of the tensors the forward made that are still alive when
    it returns (the loss's graph holds them for the backward; the
    parameters are not made by the forward)."""
    _, tm = _models("mha", rc)
    keep = {p.untyped_storage().data_ptr() for p in tm.parameters()}
    keep |= {b.untyped_storage().data_ptr() for b in tm.buffers()}
    batch = _torch_batch(_batch(b=4, s=32))
    with _LiveStorages() as mode:
        loss = _loss(tm, batch)
    held = sum(n for ptr, (ref, n) in mode.refs.items()
               if not ref.expired() and ptr not in keep)
    loss.backward()
    return held


def test_saved_bytes_order_none_selective_full():
    """What the forward leaves for the backward (the counterpart of
    ``tests/test_pipeline.py:603-634``, which reads XLA's temporaries):
    no recompute keeps every activation, selective the layer inputs
    plus the linear products, full the layer inputs only. Counted by
    live storages rather than by ``saved_tensors_hooks``: a checkpointed
    region packs its saved tensors with its own hooks, and the selective
    policy keeps its products in its own cache, so outer hooks see
    neither."""
    held = {rc: _held_bytes(rc) for rc in RECOMPUTE}
    assert held["none"] > held["selective"] > held["full"] > 0, held


def test_saved_tensors_hooks_see_only_layer_inputs_under_full():
    """What ``saved_tensors_hooks`` around the forward do see: without
    recompute every saved activation; under "full" only each
    checkpoint's inputs (the layer's input and its weight slices, views
    of the stacks) and what lies outside the trunk."""
    packed = {}
    for rc in ("none", "full"):
        _, tm = _models("mha", rc)
        keep = {p.untyped_storage().data_ptr() for p in tm.parameters()}
        seen = {}

        def pack(t):
            s = t.untyped_storage()
            if s.data_ptr() not in keep:
                seen[s.data_ptr()] = s.nbytes()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = _loss(tm, _torch_batch(_batch(b=4, s=32)))
        loss.backward()
        packed[rc] = sum(seen.values())
    assert packed["none"] > 4 * packed["full"] > 0, packed


@pytest.mark.parametrize("rc", ["full", "selective"])
def test_recompute_repeats_the_forwards_plain_choice(rc, monkeypatch):
    """The recomputed layer runs under the plain-version choice of the
    forward it repeats, whatever scope the backward runs in: a forward
    under ``ops.plain_versions()`` with the backward outside recomputes
    on the plain versions, and the other way round."""
    seen = []
    orig = LlamaDecoderLayer.forward

    def spy(self, *args, **kw):
        seen.append(ops.plain_active())
        return orig(self, *args, **kw)
    monkeypatch.setattr(LlamaDecoderLayer, "forward", spy)
    _, tm = _models("mha", rc)
    batch = _torch_batch(_batch())
    with ops.plain_versions():
        loss = _loss(tm, batch)
    loss.backward()
    assert seen == [True] * 4          # 2 layers, forward + recompute
    seen.clear()
    loss = _loss(tm, batch)
    with ops.plain_versions():
        loss.backward()
    assert seen == [False] * 4


def test_stacked_norm_weights_are_one_after_init():
    tm = LlamaForCausalLM(llama_tiny_config(scan_layers=True),
                          device="cpu")
    for n, p in tm.named_parameters():
        if "layernorm" in n or n == "llama.norm.weight":
            assert torch.equal(p, torch.ones_like(p)), n
        else:
            assert float(p.detach().std()) == pytest.approx(0.02, rel=0.2), n


def test_square_stacked_projection_loaded_untransposed_fails_parity():
    """q and o are square: a stacked (L, in, out) JAX weight loaded as
    is fits the port's (L, out, in) parameter without a shape error.
    ``params_from_jax`` transposes it; skipping that (as a converter that
    matched only the dotted names did) moves the loss far outside the
    parity tolerance."""
    jm, tm = _models("mha")
    named = _jax_named(jm)
    good = params_from_jax(named)
    q = "llama.layers.self_attn__q_proj__weight"
    assert torch.equal(good[q],
                       torch.from_numpy(named[q].copy()).transpose(1, 2))
    bad = dict(good)
    bad[q] = torch.from_numpy(named[q].copy())
    tm.load_state_dict(bad)                 # loads: the shapes agree
    jl = float(np.asarray(_loss(jm, _jax_batch(_batch()))._value))
    tl = float(_loss(tm, _torch_batch(_batch())).detach())
    assert abs(tl - jl) > 1e-5 * abs(jl) * 100
    with pytest.raises(ValueError, match="3-D linear weight"):
        params_from_jax({q: named[q][0]})


def test_config_defaults_and_checks_are_jax():
    shared = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    for f in dataclasses.fields(LlamaConfig):
        assert f.default == shared[f.name], f.name
    for bad, msg in ((dict(recompute_granularity="selectve"),
                      "recompute_granularity"),
                     (dict(sequence_parallel_mode="rings"),
                      "sequence_parallel_mode"),
                     (dict(virtual_pp=0), "virtual_pp=0"),
                     (dict(virtual_pp=2), "requires pipeline_parallel"),
                     (dict(virtual_pp=3, pipeline_parallel=True),
                      "not divisible by virtual_pp"),
                     (dict(pipeline_parallel=True,
                           sequence_parallel_mode="ring"),
                      "cannot nest"),
                     (dict(sliding_window=0), "sliding_window=0")):
        with pytest.raises(ValueError, match=msg):
            jax_tiny_config(**bad)
        with pytest.raises(ValueError, match=msg):
            llama_tiny_config(**bad)


@pytest.mark.parametrize("kw", [dict(sequence_parallel=True),
                                dict(virtual_pp=2, pipeline_parallel=True)])
def test_sequence_parallel_and_vpp_raise_not_implemented(kw):
    jax_tiny_config(**kw)                   # JAX takes them
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.6"):
        llama_tiny_config(**kw)


def test_tensor_parallel_is_inert_on_one_card():
    a = LlamaForCausalLM(llama_tiny_config(tensor_parallel=True),
                         device="cpu")
    b = LlamaForCausalLM(llama_tiny_config(tensor_parallel=False),
                         device="cpu")
    batch = _torch_batch(_batch())
    assert torch.equal(_loss(a, batch), _loss(b, batch))


def test_cache_call_on_a_stacked_model_raises_jax_error():
    _, tm = _models("mha")
    with pytest.raises(ValueError, match="KV-cache decode is not supported "
                                         "with the stacked"):
        tm.generate(np.zeros((1, 4), np.int32), max_new_tokens=2)


def test_num_params_and_flops_match_unstacked_and_jax():
    jm, tm = _models("gqa")
    um = _unstacked_from(tm, "gqa")
    assert tm.num_params() == um.num_params() == jm.num_params()
    assert tm.flops_per_token(64) == um.flops_per_token(64) \
        == jm.flops_per_token(64)


def test_headline_configs_build_in_the_port():
    """``tools/port_train_bench.headline_big_config`` is the JAX
    ``_bench_common.headline_big_config`` field for field, and the
    port's model builds from it (on the meta device: no memory)."""
    import _bench_common
    from tools.port_train_bench import headline_big_config
    for gran in ("full", "selective"):
        want = dataclasses.asdict(_bench_common.headline_big_config(gran))
        got = dataclasses.asdict(headline_big_config(gran))
        assert got == {k: want[k] for k in got}, gran
    from paddle_tpu_torch.models.llama import LlamaModel
    cfg = headline_big_config("full")
    trunk = LlamaModel(cfg, device="meta", dtype=torch.bfloat16)
    n = sum(p.numel() for p in trunk.parameters()) \
        + cfg.vocab_size * cfg.hidden_size          # the untied head
    assert isinstance(trunk.layers, LlamaDecoderStack)
    assert n == 953_223_168
    assert trunk.layers.mlp__up_proj__weight.shape == (16, 5632, 2048)


def test_bench_script_and_new_modules_import_no_jax():
    """A fresh interpreter imports ``tools/port_train_bench.py`` (and
    builds its configs), the scheduler and clipping modules: neither jax
    nor paddle_tpu is loaded, and the script's source imports
    neither."""
    import os
    import pathlib
    import subprocess
    import sys
    repo = pathlib.Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            "import paddle_tpu_torch.nn.utils, paddle_tpu_torch.optimizer.lr\n"
            "from tools.port_train_bench import headline_big_config\n"
            "headline_big_config('selective')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PATH="/usr/bin:/bin"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for line in (repo / "tools" / "port_train_bench.py").read_text() \
            .splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert s.split()[1].split(".")[0] not in ("jax", "paddle_tpu"), s
