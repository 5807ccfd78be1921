"""The port's mesh and collectives against the JAX package's.

``paddle_tpu_torch.distributed.collectives`` runs every shard of a mesh
from one controller: its in-program collectives take the list of
per-shard tensors, its host wrappers stacked per-device contributions,
as JAX's host wrappers do. Both packages run on a 2x4 mesh here: JAX's
over the 8 simulated CPU devices ``tests/conftest.py`` forces, the
port's over 8 logical CPU devices (``["cpu"] * 8``). Pinned, mirroring
``tests/test_collectives.py``:

- the plans equal JAX's (two-level, axis order, flat fallback, degree-1
  axes dropped, forced flat, unknown axes);
- hierarchical all-reduce / reduce-scatter / all-gather equal the flat
  ones and JAX's bit for bit on integer-valued data (fp32 sums exact in
  any order), with JAX's chunk placement;
- the int8 all-reduce: inside the documented bound, exact for constant
  and zero buckets, the in-program bound covering the measured error,
  the codes and scales of ``_quantize`` equal to JAX's, and the reduced
  values within one quantization step of JAX's (almost all equal);
- the mesh: repeated devices, sizes, the current mesh,
  ``HybridCommunicateGroup``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed import collectives as jcc
from paddle_tpu.distributed.collectives.quantized import (
    _quantize as jax_quantize)
from paddle_tpu.distributed.mesh import build_device_mesh as jax_mesh

from paddle_tpu_torch.distributed import collectives as cc
from paddle_tpu_torch.distributed.collectives import (
    configure, int8_error_bound, plan_hierarchy)
from paddle_tpu_torch.distributed.collectives.hierarchical import (
    hier_all_gather, hier_all_reduce)
from paddle_tpu_torch.distributed.collectives.quantized import (
    _quantize, quantized_all_reduce)
from paddle_tpu_torch.distributed.mesh import (
    HybridCommunicateGroup, axis_devices, build_device_mesh,
    get_current_mesh, set_current_mesh)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 simulated devices")

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def meshes():
    return build_device_mesh({"dp": 2, "mp": 4}, devices=CPU8), \
        jax_mesh({"dp": 2, "mp": 4})


def _idata(rs, shape, lo=-32, hi=32):
    # integer-valued fp32: sums are exact in any order, so the
    # comparisons are bit comparisons
    return rs.randint(lo, hi, size=shape).astype(np.float32)


def _np(t):
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)


class TestMesh:
    def test_repeated_devices_and_shape(self, meshes):
        mesh, jm = meshes
        assert mesh.axis_names == tuple(jm.axis_names)
        assert mesh.devices.shape == jm.devices.shape
        assert mesh.shape == dict(zip(jm.axis_names, jm.devices.shape))
        assert mesh.size == 8
        assert all(d == torch.device("cpu")
                   for d in mesh.devices.reshape(-1))
        assert len(axis_devices(mesh, ("mp",))) == 4
        assert len(axis_devices(mesh, ("dp", "mp"))) == 8

    def test_size_mismatch_and_no_gpu(self):
        with pytest.raises(ValueError, match="needs 8 devices"):
            build_device_mesh({"dp": 2, "mp": 4}, devices=["cpu"] * 4)
        assert build_device_mesh({"mp": 2}, devices=CPU8,
                                 allow_subset=True).size == 2
        with pytest.raises(ValueError, match="unknown mesh axes"):
            build_device_mesh({"tp": 2}, devices=CPU8[:2])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="devices="):
                build_device_mesh({"mp": 2})

    def test_hybrid_group_sets_the_current_mesh(self):
        prev = get_current_mesh()
        try:
            hcg = HybridCommunicateGroup(dp_degree=2, mp_degree=4,
                                         devices=CPU8)
            assert get_current_mesh() is hcg.mesh
            assert hcg.axis_size("mp") == 4 and hcg.axis_size("pp") == 1
            assert hcg.topology().world_size() == 8
        finally:
            set_current_mesh(prev)


class TestPlan:
    @pytest.mark.parametrize("axes,hier", [(("dp", "mp"), None),
                                           (("mp", "dp"), None),
                                           (("mp",), None),
                                           (("dp", "mp"), "flat")])
    def test_plans_equal_jax(self, meshes, axes, hier):
        mesh, jm = meshes
        p = plan_hierarchy(axes, mesh, hier)
        j = jcc.plan_hierarchy(axes, jm, hier)
        assert (p.axes, p.outer, p.inner, p.inner_size, p.total_size,
                p.flat, p.mode) == (j.axes, j.outer, j.inner,
                                    j.inner_size, j.total_size, j.flat,
                                    j.mode)

    def test_degree_one_axes_dropped(self):
        p = plan_hierarchy(("dp", "mp"),
                           build_device_mesh({"dp": 1, "mp": 8}, CPU8))
        assert p.flat and p.axes == ("mp",) and p.total_size == 8

    def test_unknown_axis_raises(self, meshes):
        with pytest.raises(ValueError, match="not in mesh"):
            plan_hierarchy(("nope",), meshes[0])


class TestHierarchicalBitIdentity:
    @pytest.mark.parametrize("shape", [(64,), (37,), (8, 7)])
    def test_all_reduce(self, meshes, shape):
        # 37 elements: not divisible by inner_size=4 (the padding path)
        mesh, jm = meshes
        x = _idata(np.random.RandomState(0), (8,) + shape)
        flat = _np(cc.all_reduce(x, ("dp", "mp"), mesh, compress=None,
                                 hierarchy="flat"))
        hier = _np(cc.all_reduce(x, ("dp", "mp"), mesh, compress=None,
                                 hierarchy="auto"))
        want = _np(jcc.all_reduce(x, ("dp", "mp"), jm, compress=None,
                                  hierarchy="auto"))
        np.testing.assert_array_equal(flat, hier)
        np.testing.assert_array_equal(hier, want)
        np.testing.assert_array_equal(flat, x.sum(axis=0))

    def test_reduce_scatter_placement(self, meshes):
        # row d is device d's chunk: pins the chunk ASSIGNMENT
        mesh, jm = meshes
        x = _idata(np.random.RandomState(1), (8, 32))
        flat = _np(cc.reduce_scatter(x, ("dp", "mp"), mesh,
                                     hierarchy="flat"))
        hier = _np(cc.reduce_scatter(x, ("dp", "mp"), mesh,
                                     hierarchy="auto"))
        want = _np(jcc.reduce_scatter(x, ("dp", "mp"), jm,
                                      hierarchy="auto"))
        assert flat.shape == (8, 4)
        np.testing.assert_array_equal(flat, hier)
        np.testing.assert_array_equal(hier, want)
        total = x.sum(axis=0)
        for d in range(8):
            np.testing.assert_array_equal(flat[d], total[4 * d:4 * d + 4])

    def test_all_gather_order(self, meshes):
        mesh, jm = meshes
        x = _idata(np.random.RandomState(2), (8, 5))
        flat = _np(cc.all_gather(x, ("dp", "mp"), mesh, hierarchy="flat"))
        hier = _np(cc.all_gather(x, ("dp", "mp"), mesh, hierarchy="auto"))
        want = _np(jcc.all_gather(x, ("dp", "mp"), jm, hierarchy="auto"))
        np.testing.assert_array_equal(flat, hier)
        np.testing.assert_array_equal(hier, want)
        np.testing.assert_array_equal(flat, x.reshape(-1))

    def test_in_program_every_shard_holds_the_same_bits(self, meshes):
        """The list form: each shard's result equal, gathers exact;
        real-valued sums add in the plan's fixed order on every
        shard."""
        mesh, _ = meshes
        rs = np.random.RandomState(5)
        xs = [torch.from_numpy(rs.randn(3, 5).astype(np.float32))
              for _ in range(8)]
        for hier in ("auto", "flat"):
            plan = plan_hierarchy(("dp", "mp"), mesh, hier)
            red = hier_all_reduce(xs, plan)
            assert all(torch.equal(r, red[0]) for r in red)
            np.testing.assert_allclose(red[0].numpy(),
                                       sum(x.numpy() for x in xs),
                                       rtol=1e-6, atol=1e-6)
            gat = hier_all_gather(xs, plan)
            assert all(torch.equal(g, torch.cat(xs)) for g in gat)

    def test_errors(self, meshes):
        mesh, _ = meshes
        with pytest.raises(ValueError, match="not divisible"):
            cc.reduce_scatter(np.zeros((8, 30), np.float32),
                              ("dp", "mp"), mesh)
        with pytest.raises(ValueError, match="dim 0"):
            cc.all_reduce(np.zeros((4, 8), np.float32), ("dp", "mp"),
                          mesh)
        with pytest.raises(ValueError, match="needs a mesh|need a mesh"):
            prev = get_current_mesh()
            set_current_mesh(None)
            try:
                cc.all_reduce(np.zeros((8, 8), np.float32))
            finally:
                set_current_mesh(prev)

    def test_tensor_in_tensor_out(self, meshes):
        out = cc.all_reduce(torch.ones(8, 6), ("dp", "mp"), meshes[0],
                            compress=None)
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), np.full(6, 8.0))


class TestQuantizedAllReduce:
    @pytest.mark.parametrize("hierarchy", ["auto", "flat"])
    def test_within_documented_bound(self, meshes, hierarchy):
        mesh, _ = meshes
        x = np.random.RandomState(3).randn(8, 3000).astype(np.float32) * 5
        ref = _np(cc.all_reduce(x, ("dp", "mp"), mesh, compress=None,
                                hierarchy="flat"))
        q = _np(cc.all_reduce(x, ("dp", "mp"), mesh, compress="int8",
                              hierarchy=hierarchy))
        bound = float(int8_error_bound(
            np.abs(x).max(), 8, bucket_absmax_out=np.abs(ref).max()))
        assert np.abs(q - ref).max() <= bound
        assert bound < np.abs(ref).max()

    @pytest.mark.parametrize("hierarchy", ["auto", "flat"])
    def test_constant_input_exact(self, meshes, hierarchy):
        for v in (3.25, -0.875, 11.0):
            x = np.full((8, 1037), v, np.float32)
            out = _np(cc.all_reduce(x, ("dp", "mp"), meshes[0],
                                    compress="int8", hierarchy=hierarchy))
            np.testing.assert_array_equal(out, np.full(1037, v * 8))

    def test_zero_buckets_exact(self, meshes):
        out = _np(cc.all_reduce(np.zeros((8, 64), np.float32),
                                ("dp", "mp"), meshes[0], compress="int8"))
        assert np.all(out == 0)

    @pytest.mark.parametrize("hierarchy", ["auto", "flat"])
    def test_runtime_error_bound_in_program(self, meshes, hierarchy):
        mesh, _ = meshes
        plan = plan_hierarchy(("dp", "mp"), mesh, hierarchy)
        x = np.random.RandomState(4).randn(8, 777).astype(np.float32)
        outs, bound = quantized_all_reduce(
            [torch.from_numpy(r) for r in x], plan,
            return_error_bound=True)
        err = np.abs(outs[0].numpy() - x.sum(axis=0)).max()
        assert err <= float(bound)
        assert all(torch.equal(o, outs[0]) for o in outs)

    def test_config_routes_compress(self, meshes):
        x = np.full((8, 512), 1.5, np.float32)
        with configure(compress="int8"):
            out = _np(cc.all_reduce(x, ("dp", "mp"), meshes[0]))
        np.testing.assert_array_equal(out, np.full(512, 12.0))

    def test_codes_and_scales_equal_jax(self):
        x = np.random.RandomState(6).randn(4 * 512).astype(np.float32) * 3
        q, s = _quantize(torch.from_numpy(x), 512)
        jq, js = jax_quantize(jnp.asarray(x), 512)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))

    @pytest.mark.parametrize("hierarchy", ["auto", "flat"])
    def test_values_agree_with_jax(self, meshes, hierarchy):
        """The same wire format in both packages: the codes and scales
        are equal, and the fp32 accumulation differs only in the order
        of its additions, so a result moves by an ulp or, where that
        moves a phase-2 code across a rounding boundary, by one
        quantization step of its bucket; almost all are equal."""
        mesh, jm = meshes
        x = np.random.RandomState(7).randn(8, 2048).astype(np.float32)
        got = _np(cc.all_reduce(x, ("dp", "mp"), mesh, compress="int8",
                                hierarchy=hierarchy))
        want = _np(jcc.all_reduce(x, ("dp", "mp"), jm, compress="int8",
                                  hierarchy=hierarchy))
        step = np.abs(want).max() / 127
        assert np.abs(got - want).max() <= step * 1.001
        assert np.mean(got == want) >= 0.99
