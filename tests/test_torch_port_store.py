"""The port's TCP store against the JAX package's, on the CPU.

A port ``MasterDaemon`` serves JAX ``TCPStore`` clients and a JAX daemon
serves port clients, with the native library on both sides (the wire
protocol of ``core/native/ptcore.cc``, byte for byte) and with the
Python servers and clients of both (JAX's pickle frames). Then a JAX
rank and a port rank exchange fp32 and bf16 tensors through one store
(``send``/``recv``: the same keys and the same ``RAW0``/``BF16`` npy
frames), both driven from threads of this process; and the frames
themselves are byte-equal. All exact: the store moves bytes."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import native_api as jnative
from paddle_tpu.distributed import communication as jcomm

from paddle_tpu_torch.core import native_api as tnative
from paddle_tpu_torch.distributed import communication as tcomm


@pytest.fixture(params=["native", "python"])
def kind(request, monkeypatch):
    """Both packages' stores native, or both on their Python server and
    client (the path of a machine without a compiler)."""
    if request.param == "python":
        monkeypatch.setattr(tnative, "load_tcp_store", lambda: None)
        monkeypatch.setattr(jnative, "load_native", lambda: None)
    elif jnative.load_native() is None or tnative.load_tcp_store() is None:
        pytest.skip("a native store library did not build here")
    return request.param


def _exercise(a, b, ns):
    """Two clients of one daemon, ``a`` of one package and ``b`` of the
    other: every operation's effect seen from the other side (keys under
    ``ns``)."""
    blob = bytes(range(256)) * 300          # past the first 64 KiB buffer
    a.set(ns + "k", blob)
    assert b.get(ns + "k") == blob
    b.set(ns + "s", "text")
    assert a.get(ns + "s") == b"text"
    assert a.add(ns + "n", 5) == 5 and b.add(ns + "n", -7) == -2
    assert a.add(ns + "n", 0) == -2
    assert b.check(ns + "k") and not b.check(ns + "missing")
    a.delete_key(ns + "k")
    assert not b.check(ns + "k")
    got = []
    t = threading.Thread(target=lambda: got.append(a.get(ns + "late")))
    t.start()
    b.set(ns + "late", b"\x00\x01")
    t.join(10)
    assert got == [b"\x00\x01"] and not t.is_alive()
    a.world_size = b.world_size = 2
    t = threading.Thread(target=lambda: a.barrier(ns + "bar"))
    t.start()
    b.barrier(ns + "bar")
    t.join(10)
    assert not t.is_alive()


def test_port_daemon_serves_jax_clients(kind):
    daemon = tnative.MasterDaemon(0)
    assert daemon.is_native == (kind == "native")
    a = tnative.TCPStore("127.0.0.1", daemon.port)
    b = jnative.TCPStore("127.0.0.1", daemon.port)
    try:
        assert a.is_native == (kind == "native")
        _exercise(a, b, "1/")
        _exercise(b, a, "2/")
    finally:
        a.close()
        b.close()
        daemon.stop()


def test_jax_daemon_serves_port_clients(kind):
    daemon = jnative.MasterDaemon(0)
    a = jnative.TCPStore("127.0.0.1", daemon.port)
    b = tnative.TCPStore("127.0.0.1", daemon.port)
    try:
        _exercise(b, a, "1/")
        _exercise(a, b, "2/")
    finally:
        a.close()
        b.close()
        daemon.stop()


def test_master_client_owns_the_daemon():
    s = tnative.TCPStore("127.0.0.1", 0, is_master=True)
    other = tnative.TCPStore("127.0.0.1", s.port)
    s.set("x", b"1")
    assert other.get("x") == b"1"
    other.close()
    s.close()
    with pytest.raises(ConnectionError):
        tnative.TCPStore("127.0.0.1", s.port, timeout=0.3)


@pytest.mark.parametrize("value", [
    np.arange(12, dtype=np.float32).reshape(3, 4) - 5.5,
    np.arange(6, dtype=np.int32),
    np.float32(2.5),
    "bf16"])
def test_frames_are_byte_equal(value):
    if isinstance(value, str):
        a = np.random.RandomState(0).randn(4, 3).astype(np.float32)
        j = jnp.asarray(a).astype(jnp.bfloat16)
        t = torch.from_numpy(a).to(torch.bfloat16)
    else:
        j, t = jnp.asarray(value), torch.from_numpy(np.asarray(value))
    frame = tcomm._pack(t)
    assert frame == jcomm._pack(np.asarray(j))
    back = tcomm._unpack(jcomm._pack(np.asarray(j)))
    assert back.dtype == t.dtype and torch.equal(back, t)
    np.testing.assert_array_equal(np.asarray(jcomm._unpack(frame)),
                                  np.asarray(j))


@pytest.fixture
def two_package_job(monkeypatch, kind):
    """Rank 0 is the JAX package, rank 1 the port, one store between
    them: JAX's rank 0 hosts the daemon (``PADDLE_MASTER``)."""
    port = tnative.MasterDaemon(0)
    free = port.port
    port.stop()
    monkeypatch.setenv("PADDLE_MASTER", f"127.0.0.1:{free}")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    monkeypatch.setattr(jcomm, "_my_rank", lambda: 0)
    monkeypatch.setattr(tcomm, "_my_rank", lambda: 1)
    monkeypatch.setattr(jcomm, "_STORE", None)
    monkeypatch.setattr(tcomm, "_STORE", None)
    for m in (jcomm, tcomm):
        monkeypatch.setattr(m, "_SEND_SEQ", {})
        monkeypatch.setattr(m, "_RECV_SEQ", {})
    jcomm._get_store()                          # the daemon first
    yield
    tcomm._STORE.close()
    jcomm._STORE.close()


def test_jax_and_port_ranks_exchange(two_package_job):
    rs = np.random.RandomState(3)
    f32 = rs.randn(5, 7).astype(np.float32)
    b16 = rs.randn(64).astype(np.float32)
    out = {}

    def port_rank():
        buf = torch.zeros(5, 7)
        tcomm.recv(buf, src=0)
        out["port_f32"] = buf
        buf16 = torch.zeros(64, dtype=torch.bfloat16)
        tcomm.recv(buf16, src=0)
        out["port_b16"] = buf16
        tcomm.send(torch.from_numpy(f32) * 2, dst=0)
        tcomm.send(torch.from_numpy(b16).to(torch.bfloat16) * 2, dst=0)

    t = threading.Thread(target=port_rank)
    t.start()
    jcomm.send(paddle.to_tensor(f32), dst=1)
    jcomm.send(paddle.to_tensor(jnp.asarray(b16).astype(jnp.bfloat16)),
               dst=1)
    back = jcomm.recv(paddle.to_tensor(np.zeros((5, 7), np.float32)),
                      src=1)
    back16 = jcomm.recv(paddle.to_tensor(jnp.zeros(64, jnp.bfloat16)),
                        src=1)
    t.join(30)
    assert not t.is_alive()
    np.testing.assert_array_equal(out["port_f32"].numpy(), f32)
    want16 = np.asarray(jnp.asarray(b16).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    np.testing.assert_array_equal(out["port_b16"].float().numpy(), want16)
    np.testing.assert_array_equal(np.asarray(back._value), f32 * 2)
    np.testing.assert_array_equal(
        np.asarray(back16._value.astype(jnp.float32)), want16 * 2)
    assert tcomm._get_store().is_native == (jnative.load_native()
                                            is not None)
