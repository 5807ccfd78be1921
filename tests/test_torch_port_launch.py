"""The port's launcher, spawn, elastic manager and consistency check,
against the JAX package's behaviour (``tests/test_launch_elastic.py``),
on the CPU.

Launch: the env contract (JAX's ``PADDLE_*`` variables with
``torch.distributed``'s beside them, two distinct endpoints), the
failing worker's exit code, relaunch on failure, the ``python -m`` CLI
and ``spawn``; ``DistributedBatchSampler`` under launch gives each rank
JAX's shard. ``ElasticManager`` membership and its generation, over a
port daemon and over a JAX one. Consistency: fingerprints stable and
sensitive, a diverging rank named, port and JAX ranks comparing through
one store."""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

from paddle_tpu import io as jio
from paddle_tpu.core import native_api as jnative
from paddle_tpu.distributed import consistency as jcons

from paddle_tpu_torch.core.native_api import MasterDaemon, TCPStore
from paddle_tpu_torch.distributed.consistency import (
    ConsistencyError, check_program_consistency, program_fingerprint)
from paddle_tpu_torch.distributed.elastic import (ElasticManager,
                                                  ElasticStatus)
from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PYPATH = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                           "")}
CONTRACT = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER",
            "PADDLE_LOCAL_RANK", "PADDLE_LOCAL_SIZE", "PADDLE_RESTART_COUNT",
            "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT")


def write_script(tmp_path, body, name="train.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


_DUMP_ENV = f"""
    import json, os, sys
    keys = {CONTRACT!r}
    with open(os.path.join(sys.argv[1],
                           "env" + os.environ["PADDLE_TRAINER_ID"]), "w") as f:
        json.dump({{k: os.environ[k] for k in keys}}, f)
"""


class TestLaunch:
    def test_pod_env_contract(self, tmp_path):
        script = write_script(tmp_path, _DUMP_ENV)
        cfg = LaunchConfig(script, [str(tmp_path)], nproc_per_node=2,
                           log_dir=str(tmp_path / "log"))
        assert launch_pod(cfg) == 0
        assert cfg.master != cfg.rendezvous
        for rank in (0, 1):
            env = json.loads((tmp_path / f"env{rank}").read_text())
            assert env["PADDLE_TRAINER_ID"] == env["RANK"] == str(rank)
            assert env["PADDLE_TRAINERS_NUM"] == env["WORLD_SIZE"] == "2"
            assert env["PADDLE_LOCAL_RANK"] == env["LOCAL_RANK"] == str(rank)
            assert env["PADDLE_LOCAL_SIZE"] == env["LOCAL_WORLD_SIZE"] == "2"
            assert env["PADDLE_MASTER"] == cfg.master
            assert f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}" \
                == cfg.rendezvous
            assert env["PADDLE_RESTART_COUNT"] == "0"

    def test_rendezvous_follows_a_given_master(self):
        cfg = LaunchConfig("x.py", master="10.0.0.1:6170")
        assert cfg.rendezvous == "10.0.0.1:6171"
        cfg = LaunchConfig("x.py", master="h:1", rendezvous="h:9")
        assert cfg.rendezvous == "h:9"

    def test_failure_exit_code(self, tmp_path):
        script = write_script(tmp_path, """
            import os, sys
            sys.exit(7 if os.environ["PADDLE_TRAINER_ID"] == "1" else 0)
        """)
        cfg = LaunchConfig(script, [], nproc_per_node=2,
                           log_dir=str(tmp_path / "log"))
        assert launch_pod(cfg) == 7

    def test_elastic_relaunch(self, tmp_path):
        # worker 0 crashes on the first launch only; with max_restarts=2
        # the pod is relaunched once and the second launch succeeds
        script = write_script(tmp_path, """
            import os, sys
            marker = os.path.join(sys.argv[1], "crashed_once")
            if os.environ["PADDLE_TRAINER_ID"] == "0" and \\
                    not os.path.exists(marker):
                open(marker, "w").close()
                sys.exit(1)
            restart = os.environ["PADDLE_RESTART_COUNT"]
            open(os.path.join(
                sys.argv[1],
                f"ok{os.environ['PADDLE_TRAINER_ID']}_{restart}"),
                "w").close()
        """)
        cfg = LaunchConfig(script, [str(tmp_path)], nproc_per_node=2,
                           log_dir=str(tmp_path / "log"), max_restarts=2)
        assert launch_pod(cfg) == 0
        assert (tmp_path / "ok0_1").exists()
        assert (tmp_path / "ok1_1").exists()
        assert not (tmp_path / "ok0_2").exists()
        assert sorted(p.name for p in (tmp_path / "log").iterdir()) == [
            "workerlog.0.r0", "workerlog.0.r1", "workerlog.1.r0",
            "workerlog.1.r1"]

    def test_cli_entrypoint(self, tmp_path):
        script = write_script(tmp_path, _DUMP_ENV)
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "2", "--devices", "0,1", "--master",
             "127.0.0.1:0", "--rendezvous", "127.0.0.1:1", "--log_dir",
             str(tmp_path / "log"), script, str(tmp_path)],
            env={**os.environ, **PYPATH}, timeout=120, capture_output=True)
        assert r.returncode == 0, r.stderr.decode()
        envs = [json.loads((tmp_path / f"env{k}").read_text())
                for k in (0, 1)]
        assert [e["PADDLE_TRAINER_ID"] for e in envs] == ["0", "1"]
        assert {e["MASTER_PORT"] for e in envs} == {"1"}

    def test_spawn_sets_the_contract(self, tmp_path):
        script = write_script(tmp_path, f"""
            import json, os, sys
            from paddle_tpu_torch.distributed.launch_utils import spawn

            def target(out):
                keys = {CONTRACT!r}
                with open(os.path.join(out, "env" + os.environ["RANK"]),
                          "w") as f:
                    json.dump({{k: os.environ[k] for k in keys}}, f)

            if __name__ == "__main__":
                spawn(target, args=(sys.argv[1],), nprocs=2)
        """, name="spawner.py")
        r = subprocess.run([sys.executable, script, str(tmp_path)],
                           env={**os.environ, **PYPATH}, timeout=120,
                           capture_output=True)
        assert r.returncode == 0, r.stderr.decode()
        envs = [json.loads((tmp_path / f"env{k}").read_text())
                for k in (0, 1)]
        assert [e["PADDLE_TRAINER_ID"] for e in envs] == ["0", "1"]
        assert envs[0]["PADDLE_MASTER"] != \
            f"{envs[0]['MASTER_ADDR']}:{envs[0]['MASTER_PORT']}"


def test_distributed_batch_sampler_under_launch(tmp_path):
    """Each launched rank's sampler defaults to its rank and the world
    size from the launch contract, and yields JAX's shard for that
    rank."""
    script = write_script(tmp_path, """
        import json, os, sys
        from paddle_tpu_torch import io
        s = io.DistributedBatchSampler(list(range(11)), 2, shuffle=True)
        s.set_epoch(3)
        with open(os.path.join(sys.argv[1], "s" + os.environ["RANK"]),
                  "w") as f:
            json.dump({"nranks": s.nranks, "rank": s.local_rank,
                       "batches": list(s)}, f)
    """)
    cfg = LaunchConfig(script, [str(tmp_path)], nproc_per_node=3,
                       log_dir=str(tmp_path / "log"),
                       envs={**PYPATH, "OMP_NUM_THREADS": "1"})
    assert launch_pod(cfg) == 0
    for r in range(3):
        got = json.loads((tmp_path / f"s{r}").read_text())
        j = jio.DistributedBatchSampler(list(range(11)), 2, num_replicas=3,
                                        rank=r, shuffle=True)
        j.set_epoch(3)
        assert (got["nranks"], got["rank"]) == (3, r)
        assert got["batches"] == [list(map(int, b)) for b in j]


class TestElasticManager:
    @pytest.mark.parametrize("daemon_pkg", ["port", "jax"])
    def test_membership_and_scale_event(self, daemon_pkg):
        daemon = MasterDaemon(0) if daemon_pkg == "port" \
            else jnative.MasterDaemon(0)
        m1 = ElasticManager("127.0.0.1", daemon.port, node_id="n1",
                            heartbeat_interval=0.2, heartbeat_timeout=1.5)
        m1.register()
        assert m1.alive_nodes() == ["n1"]
        m2 = ElasticManager("127.0.0.1", daemon.port, node_id="n2",
                            heartbeat_interval=0.2, heartbeat_timeout=1.5)
        m2.register()
        assert sorted(m1.alive_nodes()) == ["n1", "n2"]
        # n2's join changed the count since m1's snapshot
        assert m1.watch(poll=0.1) == ElasticStatus.RESTART
        assert m2.generation >= 1
        m2.close()
        t0 = time.time()
        assert m1.watch(poll=0.1) == ElasticStatus.RESTART
        assert time.time() - t0 < 10
        m1.close()
        daemon.stop()

    def test_completion_via_should_stop(self):
        daemon = MasterDaemon(0)
        m = ElasticManager("127.0.0.1", daemon.port, node_id="solo",
                           heartbeat_interval=0.2)
        m.register()
        assert m.watch(poll=0.05, should_stop=lambda: True) \
            == ElasticStatus.COMPLETED
        m.close()
        daemon.stop()


class TestProgramConsistency:
    def test_fingerprint_stable_and_sensitive(self):
        f1 = program_fingerprint(lambda x: x * 2 + 1, torch.ones(4))
        assert f1 == program_fingerprint(lambda x: x * 2 + 1, torch.ones(4))
        for other in (
                program_fingerprint(lambda x: x * 3 + 1, torch.ones(4)),
                program_fingerprint(lambda x: x * 2 + 1, torch.ones(8)),
                program_fingerprint(lambda x: x * 2 + 1,
                                    torch.ones(4, dtype=torch.float64)),
                program_fingerprint(lambda x: x + 2, torch.ones(4))):
            assert other != f1

    def test_fingerprint_of_a_model_follows_its_shapes(self):
        from paddle_tpu_torch.models import (LlamaForCausalLM,
                                             llama_tiny_config)
        m = LlamaForCausalLM(llama_tiny_config(), device="cpu", seed=0)
        m2 = LlamaForCausalLM(llama_tiny_config(), device="cpu", seed=1)

        def fp(model, s):
            ids = torch.zeros(2, s, dtype=torch.int32)
            return program_fingerprint(lambda a, b: model(a, b)[0], ids, ids)
        assert fp(m, 8) == fp(m2, 8)       # other weights, one program
        assert fp(m, 8) != fp(m, 16)

    @pytest.mark.parametrize("other_pkg", ["port", "jax"])
    def test_cross_rank_check(self, other_pkg):
        daemon = MasterDaemon(0)
        s0 = TCPStore("127.0.0.1", daemon.port)
        s1 = TCPStore("127.0.0.1", daemon.port)
        other = check_program_consistency if other_pkg == "port" \
            else jcons.check_program_consistency
        results = {}

        def run(rank, store, fn):
            results[rank] = fn("aaa", store=store, rank=rank, world_size=2)
        threads = [threading.Thread(target=run, args=a) for a in
                   ((0, s0, check_program_consistency), (1, s1, other))]
        [t.start() for t in threads]
        [t.join(timeout=30) for t in threads]
        assert results == {0: True, 1: True}
        s0.set("consistency2/0", "aaa")
        with pytest.raises(ConsistencyError, match=r"rank\(s\) \[0\]"):
            check_program_consistency("bbb", store=s1, rank=1,
                                      world_size=2, key="consistency2")
        with pytest.raises(ConsistencyError, match="did not publish"):
            check_program_consistency("ccc", store=s1, rank=1,
                                      world_size=2, key="consistency3",
                                      timeout=0.3)
        s0.close()
        s1.close()
        daemon.stop()
