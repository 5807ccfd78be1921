"""Port kernels (paddle_tpu_torch.ops) against the JAX package.

The port's plain versions of the RMSNorm and paged-attention decode
kernels, run on the CPU, are held against the JAX package's Pallas
kernels run in interpret mode and against its references, on the same
numpy inputs. The CUDA kernels themselves run only on a GPU: their tests
are in test_torch_port_gpu.py. Also the device and import rules of the
port: no silent CPU path, no build at import, no JAX."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused as jfused
from paddle_tpu.ops.pallas import paged_attention as jpa

import paddle_tpu_torch
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import build
from paddle_tpu_torch.ops.fused import rms_norm, rms_norm_reference
from paddle_tpu_torch.ops.paged_attention import (paged_attention_decode,
                                                  paged_attention_reference)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def interpret(monkeypatch):
    """Pallas kernels of the JAX package in interpret mode. Newer JAX
    renamed ``pltpu.TPUCompilerParams`` to ``CompilerParams``; the alias
    lets the unchanged paged-attention kernel run here."""
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jfused, "_FORCE_INTERPRET", True)
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _paged_case(b, h, kvh, d, bs, mb, seed):
    """Arenas, a shuffled block table, ragged lengths: 1, a partial last
    block, a full table, and a dead row whose table is all trash block
    0."""
    rs = np.random.RandomState(seed)
    nb = 1 + b * mb
    q = rs.randn(b, h, d).astype(np.float32)
    ka = rs.randn(nb, bs, kvh, d).astype(np.float32)
    va = rs.randn(nb, bs, kvh, d).astype(np.float32)
    lengths = np.array([1, bs + 3, mb * bs, 5][:b], np.int32)
    table = np.zeros((b, mb), np.int32)
    perm = list(rs.permutation(np.arange(1, nb)))
    for r in range(b - 1):
        n = -(-int(lengths[r]) // bs)
        table[r, :n] = perm[:n]
        perm = perm[n:]
    return q, ka, va, table, lengths


class TestRMSNorm:
    @pytest.mark.parametrize("shape", [(4, 16, 64), (3, 128), (8, 512)])
    def test_plain_matches_jax_kernel(self, interpret, shape):
        rs = np.random.RandomState(0)
        x = rs.randn(*shape).astype(np.float32)
        w = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
        want = np.asarray(jfused.fused_rms_norm(jnp.asarray(x),
                                                jnp.asarray(w), 1e-5))
        got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                   rtol=1e-5)

    def test_bf16_order_matches_jax_reference(self):
        """Cast to the input dtype BEFORE the weight multiply (the JAX
        order); within one bf16 ulp of the JAX reference in bf16."""
        rs = np.random.RandomState(1)
        x = rs.randn(6, 256).astype(np.float32)
        w = (1 + 0.1 * rs.randn(256)).astype(np.float32)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        wj = jnp.asarray(w).astype(jnp.bfloat16)
        want = np.asarray(jfused._rms_ref(xj, wj, 1e-5, None)
                          .astype(jnp.float32))
        xt = torch.from_numpy(x).to(torch.bfloat16)
        wt = torch.from_numpy(w).to(torch.bfloat16)
        got = rms_norm(xt, wt, 1e-5)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2.0 ** -7, atol=1e-6)

    def test_cpu_tensor_runs_plain_without_build(self):
        x = torch.randn(3, 64)
        w = torch.ones(64)
        before = rms_norm.launches
        out = rms_norm(x, w, 1e-6)
        torch.testing.assert_close(out, rms_norm_reference(x, w, 1e-6))
        assert rms_norm.launches == before
        assert "rms_norm" not in build._loaded


class TestPagedAttentionDecode:
    @pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)],
                             ids=["mha", "gqa"])
    def test_plain_matches_jax_kernel_and_reference(self, interpret, h,
                                                    kvh):
        q, ka, va, table, lengths = _paged_case(4, h, kvh, 32, 8, 4,
                                                seed=h)
        scale = 1.0 / np.sqrt(32)
        j_kernel = np.asarray(jpa.paged_attention_decode(
            jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
            jnp.asarray(table), jnp.asarray(lengths), scale=scale))
        j_ref = np.asarray(jpa.paged_attention_reference(
            jnp.asarray(q)[:, None], jnp.asarray(ka), jnp.asarray(va),
            jnp.asarray(table), jnp.asarray(lengths), scale=scale))[:, 0]
        got = paged_attention_decode(
            torch.from_numpy(q), torch.from_numpy(ka), torch.from_numpy(va),
            torch.from_numpy(table), torch.from_numpy(lengths),
            scale=scale).numpy()
        np.testing.assert_allclose(got, j_ref, atol=1e-5)
        np.testing.assert_allclose(got, j_kernel, atol=1e-5)

    def test_chunk_reference_matches_jax(self):
        """The s > 1 gathered-dense sequence (chunked prefill) against
        the JAX reference: rows end at ``lengths``."""
        rs = np.random.RandomState(5)
        _, ka, va, table, _ = _paged_case(3, 8, 2, 16, 8, 4, seed=5)
        q = rs.randn(3, 5, 8, 16).astype(np.float32)
        lengths = np.array([5, 12, 32], np.int32)
        want = np.asarray(jpa.paged_attention_reference(
            jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
            jnp.asarray(table), jnp.asarray(lengths), scale=0.25))
        got = paged_attention_reference(
            torch.from_numpy(q), torch.from_numpy(ka), torch.from_numpy(va),
            torch.from_numpy(table), torch.from_numpy(lengths), scale=0.25)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


class TestDeviceAndImportRules:
    def test_gpu_default_raises_without_cuda(self, monkeypatch):
        from paddle_tpu_torch.models import (LlamaForCausalLM,
                                             llama_tiny_config)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            LlamaForCausalLM(llama_tiny_config())
        with pytest.raises(RuntimeError, match='device="cpu"'):
            paddle_tpu_torch.resolve_device("cuda")
        assert paddle_tpu_torch.resolve_device("cpu").type == "cpu"

    def test_engine_defaults_to_gpu(self, monkeypatch):
        from paddle_tpu_torch.models import (LlamaForCausalLM,
                                             llama_tiny_config)
        from paddle_tpu_torch.serving import PagedEngine
        m = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=1),
                             device="cpu")
        eng = PagedEngine(m, num_slots=1, max_len=16, block_size=8,
                          device="cpu")
        assert eng.backend.cache[0][0].device.type == "cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            PagedEngine(m, num_slots=1, max_len=16, block_size=8)

    def test_import_builds_nothing_and_loads_no_jax(self):
        """A fresh interpreter imports every module of the port: no
        kernel or native library is built or loaded, and neither jax nor
        paddle_tpu is imported."""
        code = (
            "import sys\n"
            "import paddle_tpu_torch, paddle_tpu_torch.convert\n"
            "import paddle_tpu_torch.serving, paddle_tpu_torch.models\n"
            "import paddle_tpu_torch.ops.fused\n"
            "import paddle_tpu_torch.ops.paged_attention\n"
            "import paddle_tpu_torch.ops.flash_attention\n"
            "import paddle_tpu_torch.ops.decode_layer\n"
            "import paddle_tpu_torch.nn.functional\n"
            "import paddle_tpu_torch.incubate.nn\n"
            "import paddle_tpu_torch.optimizer, paddle_tpu_torch.amp\n"
            "import paddle_tpu_torch.jit\n"
            "import paddle_tpu_torch.random, paddle_tpu_torch.utils.flags\n"
            "import paddle_tpu_torch.utils.faults\n"
            "import paddle_tpu_torch.observability\n"
            "import paddle_tpu_torch.profiler\n"
            "import paddle_tpu_torch.serving.resilience\n"
            "import paddle_tpu_torch.distributed.checkpoint\n"
            "import paddle_tpu_torch.core.native_api\n"
            "import paddle_tpu_torch.distributed\n"
            "import paddle_tpu_torch.distributed.communication\n"
            "import paddle_tpu_torch.distributed.parallel\n"
            "import paddle_tpu_torch.distributed.launch\n"
            "import paddle_tpu_torch.distributed.elastic\n"
            "import paddle_tpu_torch.distributed.consistency\n"
            "import paddle_tpu_torch.distributed.fleet.utils\n"
            "import paddle_tpu_torch.distributed.collectives.bucketing\n"
            "import paddle_tpu_torch.io\n"
            "sys.path.insert(0, 'tools')\n"
            "import port_dp_worker\n"
            "from paddle_tpu_torch import core\n"
            "from paddle_tpu_torch.ops import build\n"
            "assert not build._loaded, build._loaded\n"
            "assert not core._libs, core._libs\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
        env = dict(os.environ, PATH="/usr/bin:/bin")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "ok"

    def test_sources_never_import_jax_or_paddle_tpu(self):
        files = list((REPO / "paddle_tpu_torch").rglob("*.py")) \
            + list((REPO / "tools").glob("port_*.py")) \
            + [REPO / "chip_smoke.py"]
        assert len(files) > 10
        for f in files:
            for line in f.read_text().splitlines():
                s = line.strip()
                if not s.startswith(("import ", "from ")):
                    continue
                mod = s.split()[1]
                assert not (mod == "jax" or mod.startswith("jax.")), \
                    f"{f}: {s}"
                assert not (mod == "paddle_tpu"
                            or mod.startswith("paddle_tpu.")), f"{f}: {s}"

    def test_launch_counters_reset(self):
        ops.reset_launch_counts()
        assert ops.launch_counts() == {
            "rms_norm": 0, "paged_attention_decode": 0,
            "paged_attention_decode_int8": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "rope": 0, "adamw": 0, "xent_fwd": 0, "xent_bwd": 0,
            "moe_gather": 0, "rms_norm_residual": 0, "decode_layer": 0,
            "decode_layer_int8": 0, "rms_norm_bwd": 0,
            "weight_only_gemm": 0}
