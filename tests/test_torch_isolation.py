"""The port stands alone: no module of repro_torch (nor chip_smoke.py)
imports ``jax`` or the JAX package ``repro``, and its entry points run on
the card unless the caller asks for the CPU.

The tests that run the port with imports of jax and repro refused share one
process (the ``isolated`` fixture): it installs the import guard, imports
torch and numpy once, and runs each test's body (``_BODIES``) in a fork of
itself, so that every body starts from the same clean module table; the
guard also sits in a ``sitecustomize`` on the ``PYTHONPATH`` that the
bodies hand on to the processes they start. Each test then reads its own
body's exit status and output.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")

_GUARD = textwrap.dedent("""
    import importlib.abc, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top == "repro" or top.startswith("jax"):
                raise ModuleNotFoundError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
""")


_RUNNER = _GUARD + textwrap.dedent("""
    import contextlib, io, json, os, traceback
    import numpy, torch  # noqa: F401  (imported once, shared by every fork)

    bodies, out = json.load(open(sys.argv[1])), sys.argv[2]
    for name, body in bodies.items():
        scratch = os.path.join(out, name)
        os.makedirs(scratch)
        pid = os.fork()
        if pid == 0:
            os.environ["ISOLATION_SCRATCH"] = scratch
            stdout, stderr, rc = io.StringIO(), io.StringIO(), 0
            try:
                with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
                    exec(compile(body, name, "exec"), {"__name__": "__main__"})
            except BaseException:
                rc = 1
                stderr.write(traceback.format_exc())
            with open(scratch + ".json", "w") as f:
                json.dump({"returncode": rc, "stdout": stdout.getvalue(),
                           "stderr": stderr.getvalue()}, f)
            os._exit(0)
        os.waitpid(pid, 0)
""")
_BODIES: dict = {}


@pytest.fixture(scope="module")
def isolated(tmp_path_factory):
    """{test name: its body's returncode, stdout and stderr}, every body run
    in a fork of one guarded process."""
    tmp = tmp_path_factory.mktemp("isolation")
    (tmp / "guard").mkdir()
    (tmp / "guard" / "sitecustomize.py").write_text(_GUARD)
    (tmp / "bodies.json").write_text(json.dumps({k: textwrap.dedent(v)
                                                 for k, v in _BODIES.items()}))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(tmp / "guard"), os.path.join(ROOT, "src")]))
    proc = subprocess.run([sys.executable, "-c", _RUNNER, str(tmp / "bodies.json"),
                           str(tmp / "out")], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = {}
    for name in _BODIES:
        path = tmp / "out" / f"{name}.json"
        got = json.loads(path.read_text()) if path.exists() else {
            "returncode": -1, "stdout": "", "stderr": f"no result ({proc.stderr[-2000:]})"}
        results[name] = subprocess.CompletedProcess(name, got["returncode"], got["stdout"],
                                                    got["stderr"])
    return results


_BODIES["test_port_imports_no_jax_and_runs_a_round"] = """
        import importlib, pkgutil, sys
        import numpy as np
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "repro_torch.core.dfedrw" in names and "repro_torch.launch.train" in names

        import torch
        from repro_torch.core import DFedRW, DFedRWConfig, QuantConfig, make_topology, train_loop
        from repro_torch.core.heterogeneity import partition_similarity
        from repro_torch.data import FederatedDataset, synthetic_image_classification
        from repro_torch.models import make_fnn

        x, y = synthetic_image_classification(n_samples=400, seed=0)
        data = FederatedDataset.from_partition(
            x, y, partition_similarity(y, 6, 50, np.random.default_rng(0)))
        runner = DFedRW(make_fnn((16,)), data, make_topology("ring", 6),
                        DFedRWConfig(m_chains=2, k_walk=2, quant=QuantConfig(bits=8)),
                        device="cpu")
        hist = train_loop(runner, 1, x[:64], y[:64])
        assert np.isfinite(hist.train_loss[0])
        bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
        assert not bad, bad
        print("ok", len(names))
    """


def test_port_imports_no_jax_and_runs_a_round(isolated):
    proc = isolated["test_port_imports_no_jax_and_runs_a_round"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


_BODIES["test_port_runs_mamba_smoke_without_jax"] = """
        import sys
        import torch
        from repro_torch.configs import get_smoke
        from repro_torch.kernels.ssd_scan import ssd_scan
        from repro_torch.models import transformer as T

        cfg = get_smoke("mamba2-130m")
        params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(1))
        loss = T.loss_fn(cfg, params, {"tokens": tokens, "labels": tokens})
        logits, _ = T.forward_train(cfg, params, tokens)
        cache = T.init_cache(cfg, 2, 12, device="cpu")
        for t in range(12):
            step, cache = T.decode_step(cfg, params, cache, tokens[:, t:t + 1])
        assert torch.isfinite(loss) and step.shape == (2, 1, cfg.vocab)
        assert torch.allclose(step[:, 0], logits[:, -1], atol=2e-3, rtol=2e-3)
        assert ssd_scan.LAUNCHES["ssd_scan"] == 0
        bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
        assert not bad, bad
        print("ok")
    """


def test_port_runs_mamba_smoke_without_jax(isolated):
    """The Mamba2 slice, forward and decode, on the CPU with JAX and the JAX
    package refused."""
    proc = isolated["test_port_runs_mamba_smoke_without_jax"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


_BODIES["test_port_runs_dense_smoke_without_jax"] = """
        import sys
        import torch
        from repro_torch.configs import get_smoke
        from repro_torch.kernels.block_attn import block_attn
        from repro_torch.models import transformer as T

        cfg = get_smoke("qwen2.5-32b")
        params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(1))
        loss = T.loss_fn(cfg, params, {"tokens": tokens, "labels": tokens})
        logits, _ = T.forward_train(cfg, params, tokens)
        cache = T.init_cache(cfg, 2, 12, device="cpu")
        for t in range(12):
            step, cache = T.decode_step(cfg, params, cache, tokens[:, t:t + 1])
        assert torch.isfinite(loss) and step.shape == (2, 1, cfg.vocab)
        assert torch.allclose(step[:, 0], logits[:, -1], atol=2e-3, rtol=2e-3)
        assert block_attn.LAUNCHES["block_attn"] == 0 and block_attn.BUILD_INFO == {}
        bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
        assert not bad, bad
        print("ok")
    """


def test_port_runs_dense_smoke_without_jax(isolated):
    """The dense GQA slice, forward and decode, on the CPU with JAX and the
    JAX package refused."""
    proc = isolated["test_port_runs_dense_smoke_without_jax"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


_BODIES["test_port_runs_moe_smoke_and_renders_a_report_without_jax"] = """
        import sys
        import torch
        import repro_torch.obs as obs
        from repro_torch.configs import get_smoke
        from repro_torch.models import transformer as T
        from repro_torch.sim import build_scenario

        cfg = get_smoke("grok-1-314b")
        params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(1))
        logits, aux = T.forward_train(cfg, params, tokens)
        loss = T.loss_fn(cfg, params, {"tokens": tokens, "labels": tokens})
        cache = T.init_cache(cfg, 2, 12, device="cpu")
        step, cache = T.decode_step(cfg, params, cache, tokens[:, :1])
        assert torch.isfinite(loss) and float(aux) > 0 and logits.shape == (2, 12, cfg.vocab)
        assert step.shape == (2, 1, cfg.vocab)

        setup = build_scenario("fleet_metro", n=20, seed=0)
        runner = setup.runner(engine="fleet", device="cpu")
        rec = obs.Recorder(clock=obs.VirtualClock(), trace=True)
        runner.attach_obs(rec, trace=True)
        runner.run(2, torch.Generator().manual_seed(0), setup.x_test, setup.y_test,
                   eval_every=2)
        text = obs.render_report(rec.to_stream())
        assert "critical path" in text and "straggler league" in text
        assert obs.render_prometheus(rec.to_stream())
        bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
        assert not bad, bad
        print("ok")
    """


def test_port_runs_moe_smoke_and_renders_a_report_without_jax(isolated):
    """The MoE slice (a Grok SMOKE forward and decode) and the renderers (a
    traced simulator stream rendered with its critical path) on the CPU
    with JAX and the JAX package refused."""
    proc = isolated["test_port_runs_moe_smoke_and_renders_a_report_without_jax"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


_BODIES["test_port_runs_mla_and_encdec_smoke_without_jax"] = """
        import sys
        import torch
        from repro_torch.configs import get_arch, get_smoke
        from repro_torch.kernels.block_attn import block_attn
        from repro_torch.models import transformer as T

        assert "repro_torch.configs.deepseek_v2_lite_16b" not in sys.modules
        for arch_id in ("deepseek-v2-lite-16b", "seamless-m4t-large-v2"):
            assert get_arch(arch_id).name == arch_id
            cfg = get_smoke(arch_id)
            gen = torch.Generator().manual_seed(1)
            params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            tokens = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
            emb = torch.randn(2, cfg.frontend_tokens, cfg.d_model, generator=gen)
            emb = emb if cfg.enc_dec else None
            logits, aux = T.forward_train(cfg, params, tokens, emb)
            cache = T.init_cache(cfg, 2, 12, device="cpu")
            if cfg.enc_dec:
                cache["enc_out"] = T._run_encoder(cfg, params, emb)
            for t in range(12):
                step, cache = T.decode_step(cfg, params, cache, tokens[:, t:t + 1])
            assert torch.isfinite(logits).all() and step.shape == (2, 1, cfg.vocab)
            if not cfg.enc_dec:
                assert float(aux) > 0
        assert "repro_torch.configs.seamless_m4t_large_v2" in sys.modules
        assert block_attn.LAUNCHES["block_attn"] == 0 and block_attn.BUILD_INFO == {}
        bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
        assert not bad, bad
        print("ok")
    """


def test_port_runs_mla_and_encdec_smoke_without_jax(isolated):
    """The two families ported last, through the registry's config modules
    (``configs.deepseek_v2_lite_16b``, ``configs.seamless_m4t_large_v2``):
    MLA with MoE and the encoder-decoder over stub frames, forward and
    decode, on the CPU with JAX and the JAX package refused."""
    proc = isolated["test_port_runs_mla_and_encdec_smoke_without_jax"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


_BODIES["test_port_trains_without_jax"] = """
        import sys
        import torch
        from repro_torch.configs import get_smoke
        from repro_torch.dist import make_train_step
        from repro_torch.launch.train import main
        from repro_torch.models import transformer as T
        from repro_torch.optim import adamw_init, adamw_update, momentum_init

        cfg = get_smoke("seamless-m4t-large-v2")
        params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        vel = momentum_init(params).velocity
        gen = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=gen),
                 "labels": torch.randint(0, cfg.vocab, (2, 16), generator=gen),
                 "embeds": torch.randn(2, cfg.frontend_tokens, cfg.d_model, generator=gen)}
        params, vel, loss = make_train_step(cfg)(params, vel, batch, 0)
        assert torch.isfinite(loss)
        new, state = adamw_update({"w": torch.zeros(2)}, {"w": torch.ones(2)},
                                  adamw_init({"w": torch.zeros(2)}), 0.1)
        assert int(state["count"]) == 1
        main(["pod", "--arch", "jamba-1.5-large-398b", "--smoke", "--device", "cpu",
              "--steps", "1", "--batch", "1", "--seq", "32"])
        assert "repro_torch.dist.steps" in sys.modules and "repro_torch.optim.sgd" in sys.modules
        bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
        assert not bad, bad
        print("ok")
    """


def test_port_trains_without_jax(isolated):
    """The training slice (``dist``, ``optim``, ``launch.train pod``) on the
    CPU with imports of jax and repro refused."""
    proc = isolated["test_port_trains_without_jax"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ok" in proc.stdout and "done" in proc.stdout


_BODIES["test_port_trains_data_parallel_under_torchrun_without_jax"] = """
        import contextlib, io, json, subprocess, sys
        import repro_torch.dist.steps as steps
        from repro_torch.launch.train import main

        cmd = ["pod", "--arch", "mamba2-130m", "--smoke", "--steps", "2", "--device", "cpu"]
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "2", "-m", "repro_torch.launch.train", *cmd],
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
        sys.stdout.write(proc.stdout)
        losses, real = [], steps.make_train_step

        def spy(*args, **kw):
            step_fn = real(*args, **kw)

            def run(*a):
                out = step_fn(*a)
                losses.append(float(out[2]))
                return out
            return run

        steps.make_train_step = spy
        with contextlib.redirect_stdout(io.StringIO()) as single:
            main(cmd)
        assert single.getvalue().rstrip().endswith("done")
        print("single " + json.dumps(losses))
        bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
        assert not bad, bad
    """


def test_port_trains_data_parallel_under_torchrun_without_jax(isolated):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train pod --arch
    mamba2-130m --smoke --steps 2 --device cpu`` with imports of jax and repro
    refused in the ranks too: both on gloo on a (2, 1) mesh, equal digests of
    their gathered parameters, rank 0's lines in the reference's format
    (``step k loss=...`` a step, then ``done``), and every rank's losses
    within 1e-5 (relative) of the same call without torchrun."""
    import re

    import numpy as np

    proc = isolated["test_port_trains_data_parallel_under_torchrun_without_jax"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    heads = re.findall(r"rank (\d): backend=(\w+) mesh=(\{.*?\}) device=(\w+)", out)
    assert sorted(heads) == [(str(r), "gloo", "{'data': 2, 'model': 1}", "cpu")
                             for r in range(2)]
    digests = dict(re.findall(r"rank (\d): digest=(\w+) \(equal on all 2 ranks\)", out))
    assert sorted(digests) == ["0", "1"] and len(set(digests.values())) == 1
    lines = [line for line in out.splitlines() if not line.startswith(("rank ", "single "))]
    assert len(lines) == 3 and lines[-1] == "done"
    for step, line in enumerate(lines[:2]):
        assert re.fullmatch(rf"step {step:3d} loss=\d+\.\d{{4}} \(\d+\.\d\ds\)", line), line
    single = json.loads(out.split("single ")[1].splitlines()[0])
    timing = {int(r): json.loads(t) for r, t in re.findall(r"rank (\d): timing (.*)", out)}
    assert sorted(timing) == [0, 1] and len(single) == 2
    for t in timing.values():
        assert t["backend"] == "gloo" and len(t["ms"]) == 2
        assert all(c["calls"] > 0 and c["bytes"] > 0 for c in t["collectives"])
        np.testing.assert_allclose(t["losses"], single, rtol=1e-5, atol=0)
    for step, line in enumerate(lines[:2]):
        assert line.split("loss=")[1].split()[0] == f"{timing[0]['losses'][step]:.4f}"


_BODIES["test_port_runs_the_pod_deployment_without_jax"] = """
        import sys
        import torch
        from repro_torch.configs import get_smoke
        from repro_torch.convert import stack_pods
        from repro_torch.dist import GossipConfig, gossip_mix, make_fed_train_step
        from repro_torch.launch.mesh import make_pod_mesh
        from repro_torch.launch.train import main
        from repro_torch.models import transformer as T
        from repro_torch.optim import momentum_init
        from repro_torch.sim import WindowSchedule, build_scenario

        cfg = get_smoke("yi-6b")
        params = stack_pods(T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                            2, device="cpu")
        mixed = gossip_mix(params, GossipConfig(quant_bits=8),
                           generator=torch.Generator().manual_seed(1))
        step_fn, _, _ = make_fed_train_step(cfg, make_pod_mesh(2, device=torch.device("cpu")),
                                            GossipConfig(quant_bits=8), remat=False)
        toks = torch.randint(0, cfg.vocab, (2, 1, 17), generator=torch.Generator().manual_seed(2))
        params, vel, loss = step_fn(params, momentum_init(params).velocity,
                                    {"tokens": toks[..., :-1], "labels": toks[..., 1:]}, 0,
                                    generator=torch.Generator().manual_seed(3))
        assert torch.isfinite(loss)
        res = build_scenario("straggler_tail", n=8, seed=0).runner(device="cpu").run(
            1, torch.Generator().manual_seed(0), record=True)
        assert isinstance(res.trace.schedule()[0], WindowSchedule)
        assert res.trace.gossip_flags().sum() == 1
        main(["pod", "--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--fed", "--pods",
              "2", "--bits", "8", "--steps", "1", "--batch", "1", "--seq", "32"])
        bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
        assert not bad, bad
        print("ok")
    """


def test_port_runs_the_pod_deployment_without_jax(isolated):
    """The pod deployment (``dist.gossip``, the fed step, ``launch.mesh``,
    ``launch.train pod --fed``, ``convert.stack_pods``) and the trace's
    deployment export on the CPU with imports of jax and repro refused."""
    proc = isolated["test_port_runs_the_pod_deployment_without_jax"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ok" in proc.stdout and "inter-pod param spread" in proc.stdout


def test_pod_deployment_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA default is valid here")
    import numpy as np

    from repro_torch.convert import stack_pods
    from repro_torch.launch.train import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["pod", "--arch", "mamba2-130m", "--smoke", "--fed", "--pods", "2", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        stack_pods({"embed": np.zeros((2, 2), np.float32)}, 2)


_BODIES["test_port_serves_without_jax"] = """
        import sys
        import torch
        from repro_torch.configs import get_smoke
        from repro_torch.dist import make_prefill_step, make_serve_step
        from repro_torch.launch.serve import main
        from repro_torch.models import transformer as T
        from repro_torch.serve import EngineConfig, Request, ServeEngine

        for arch in ("mamba2-130m", "seamless-m4t-large-v2"):
            main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "4",
                  "--max-concurrency", "2", "--prompt-len", "6", "--gen", "4", "--mixed",
                  "--verify"])
        cfg = get_smoke("deepseek-v2-lite-16b")
        params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        cache = T.init_cache(cfg, 2, 8, device="cpu")
        logits, cache = make_prefill_step(cfg)(params, cache, torch.zeros(2, 4, dtype=torch.long),
                                               torch.zeros(2, dtype=torch.int32),
                                               torch.tensor([4, 1], dtype=torch.int32))
        step, _ = make_serve_step(cfg)(params, cache, torch.zeros(2, 1, dtype=torch.long),
                                                   torch.tensor([4, 1]), torch.tensor([True, False]))
        assert logits.shape == (2, 4, cfg.vocab) and step.shape == (2, 1, cfg.vocab)
        eng = ServeEngine(cfg, params, EngineConfig(max_concurrency=2, max_len=8), device="cpu")
        out = eng.run([Request(rid=i, prompt=[1, 2, 3], max_tokens=2) for i in range(3)])
        assert [len(st.generated) for st in out] == [2, 2, 2]
        assert "repro_torch.serve.engine" in sys.modules
        bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
        assert not bad, bad
        print("ok")
    """


def test_port_serves_without_jax(isolated):
    """The serving slice (``repro_torch.serve``, ``launch.serve``,
    ``transformer.prefill_chunk``, ``dist``'s serve and prefill steps) on the
    CPU with imports of jax and repro refused: the launcher verifies the
    engine against the sequential decode for a Mamba2 and an
    encoder-decoder SMOKE model."""
    proc = isolated["test_port_serves_without_jax"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ok" in proc.stdout and proc.stdout.count("verify: all 4 requests identical") == 2


_BODIES["test_port_runs_the_simulator_without_jax"] = """
        import contextlib, io, os, sys, tempfile
        import torch
        import repro_torch.launch.sim as launcher
        import repro_torch.obs as obs
        import repro_torch.sim as sim
        for engine in ("heap", "fleet"):
            setup = sim.build_scenario("fleet_metro", n=40, seed=0)
            runner = setup.runner(engine=engine, device="cpu")
            rec = obs.Recorder(clock=obs.VirtualClock(), trace=True)
            runner.attach_obs(rec)
            res = runner.run(2, torch.Generator().manual_seed(0), setup.x_test,
                             setup.y_test, eval_every=2, record=True)
            assert len(res.trace.windows) == 2 and res.history.rounds == [2]
            assert rec.to_stream().summary["counters"]["sim/windows"] == 2
        path = os.path.join(tempfile.mkdtemp(), "t.jsonl")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launcher.main(["--scenario", "straggler_tail", "--device", "cpu",
                           "--rounds", "1", "--n", "8", "--record", path])
        assert "final:" in buf.getvalue()
        bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
        assert not bad, bad
        print("ok")
    """


def test_port_runs_the_simulator_without_jax(isolated):
    """The simulator slice (sim, obs, launch.sim) on the CPU with JAX and the
    JAX package refused: a scenario with telemetry and a recorded trace on
    each engine, and the launcher."""
    proc = isolated["test_port_runs_the_simulator_without_jax"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


_BODIES["test_port_runs_the_metal_deployment_without_jax"] = """
    import os, sys
    import torch
    from repro_torch.launch.replay import main
    from repro_torch.launch.sim import main as sim_main
    from repro_torch.sim import MetalReplay, SimTrace

    trace = os.path.join(os.environ["ISOLATION_SCRATCH"], "t.jsonl")
    sim_main(["--scenario", "churn_dropout", "--n", "12", "--rounds", "2", "--seed", "2",
              "--device", "cpu", "--record", trace])
    assert main(["--trace", trace, "--processes", "2", "--check", "--fault-inject",
                 "--device", "cpu"]) == 0
    bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
    assert not bad, bad
    print("ok")
"""


def test_port_runs_the_metal_deployment_without_jax(isolated):
    """The metal replay (``repro_torch.sim.metal``) and its launcher
    (``launch.replay``) with two workers on the CPU, with imports of jax and
    repro refused in this process and, through the ``sitecustomize`` on the
    ``PYTHONPATH`` the launcher hands on, in the workers it spawns."""
    proc = isolated["test_port_runs_the_metal_deployment_without_jax"]
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "faults verified" in proc.stdout and "shards agree" in proc.stdout
    assert proc.stdout.rstrip().endswith("ok")


_BODIES["test_port_shards_without_jax"] = """
    import sys
    import numpy as np
    import torch
    from repro_torch.configs import ARCH_IDS, get_arch, get_smoke
    from repro_torch.dist.parallel import MeshAxis
    from repro_torch.dist.sharding import (cache_specs, gather_tree, opt_specs, param_specs,
                                           shard_tree)
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig, Request, ServeEngine

    for arch in ARCH_IDS:
        tree = T.abstract_params(get_arch(arch))
        for mesh in (make_production_mesh(), make_production_mesh(multi_pod=True)):
            assert param_specs(tree, mesh).keys() == opt_specs(tree, mesh).keys()
    cfg = get_smoke("yi-6b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = {"data": 1, "model": 2}
    specs = param_specs(params, mesh)
    back = gather_tree([shard_tree(params, specs, mesh, r) for r in range(2)], specs, mesh)
    assert torch.equal(back["embed"], params["embed"])
    assert cache_specs(T.init_cache(cfg, 2, 8, device="cpu"), mesh)["slots"]["slot0"]["k"] \\
        == (None, "data", None, "model", None)
    one = make_host_mesh(1, 2, device="cpu")
    assert one.shape == {"data": 1, "model": 1} and isinstance(one.axis, MeshAxis)
    eng = ServeEngine(cfg, params, EngineConfig(max_concurrency=2, max_len=8), mesh=one)
    plain = ServeEngine(cfg, params, EngineConfig(max_concurrency=2, max_len=8), device="cpu")
    reqs = [Request(rid=i, prompt=[1, 2, 3], max_tokens=2) for i in range(3)]
    assert [st.generated for st in eng.run(reqs)] == [st.generated for st in plain.run(reqs)]
    assert eng.digest == plain.digest
    bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
    assert not bad, bad
    print("ok")
"""


def test_port_shards_without_jax(isolated):
    """The sharding rules (``dist.sharding``) on the production meshes, the
    placement round trip, the host mesh and a one-rank mesh's engine on the
    CPU with imports of jax and repro refused (the launcher's ranks under
    ``torchrun`` are guarded in ``tests/test_torch_serve_sharded.py``)."""
    proc = isolated["test_port_shards_without_jax"]
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_simulator_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA default is valid here")
    from repro_torch.launch.sim import main
    from repro_torch.sim import build_scenario

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--scenario", "straggler_tail", "--rounds", "1"])
    setup = build_scenario("fleet_metro", n=20)
    for engine in ("heap", "fleet"):
        with pytest.raises(RuntimeError, match="CUDA"):
            setup.runner(engine=engine)


_BODIES["test_chip_smoke_imports_no_jax"] = """
        import runpy, subprocess, sys
        import torch
        torch.cuda.is_available = lambda: True
        sys.argv = ["chip_smoke.py"]
        try:
            runpy.run_path("chip_smoke.py", run_name="__main__")
        except (SystemExit, OSError, RuntimeError, AssertionError,
                subprocess.CalledProcessError):
            pass
        assert "repro_torch.core.dfedrw" in sys.modules
        assert "repro_torch.models.transformer" in sys.modules
        assert "repro_torch.kernels.ssd_scan.ssd_scan" in sys.modules
        assert "repro_torch.kernels.block_attn.block_attn" in sys.modules
        bad = [m for m in sys.modules if m.split(".")[0] == "repro" or m.startswith("jax")]
        assert not bad, bad
        print("ok")
    """


def test_chip_smoke_imports_no_jax(isolated):
    """chip_smoke.py's imports stand alone too. Told that there is a card,
    it imports the whole port before its first call to the card fails."""
    proc = isolated["test_chip_smoke_imports_no_jax"]
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA default is valid here")
    import numpy as np

    from repro_torch.convert import flat_from_numpy, params_from_numpy
    from repro_torch.core import DFedRW, DFedRWConfig, make_topology
    from repro_torch.core.heterogeneity import partition_similarity
    from repro_torch.data import FederatedDataset, synthetic_image_classification
    from repro_torch.launch.train import main
    from repro_torch.models import make_fnn

    x, y = synthetic_image_classification(n_samples=100, seed=0)
    data = FederatedDataset.from_partition(
        x, y, partition_similarity(y, 4, 50, np.random.default_rng(0)))
    with pytest.raises(RuntimeError, match="CUDA"):
        DFedRW(make_fnn((8,)), data, make_topology("complete", 4), DFedRWConfig())
    from repro_torch.core import BaselineConfig, DFedAvg, FedAvg

    for cls in (FedAvg, DFedAvg):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(make_fnn((8,)), data, make_topology("complete", 4), BaselineConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy([(np.zeros((2, 2)), np.zeros(2))])
    with pytest.raises(RuntimeError, match="CUDA"):
        flat_from_numpy(np.zeros((2, 128)))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["protocol", "--rounds", "1", "--devices", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["protocol", "--algo", "dsgd", "--rounds", "1", "--devices", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["pod", "--arch", "mamba2-130m", "--smoke", "--steps", "1"])

    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import transformer as T

    for arch_id in ("mamba2-130m", "yi-6b", "grok-1-314b", "deepseek-v2-lite-16b",
                    "seamless-m4t-large-v2"):
        cfg = get_smoke(arch_id)
        with pytest.raises(RuntimeError, match="CUDA"):
            T.init_params(cfg, torch.Generator())
        with pytest.raises(RuntimeError, match="CUDA"):
            T.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_numpy({"embed": np.zeros((2, 2))})

    from repro_torch.launch.serve import main as serve_main, sequential_reference
    from repro_torch.serve import Request, ServeEngine

    cfg = get_smoke("mamba2-130m")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        sequential_reference(cfg, params, Request(rid=0, prompt=[1], max_tokens=1), 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--arch", "mamba2-130m", "--requests", "1"])


def test_only_cpu_tensors_take_the_plain_path():
    """The plain version runs only because the tensor lies on the CPU, or
    shape-only on meta (the dry run's count, nothing computed, no launch); a
    tensor on any other device is refused."""
    import types

    from repro_torch.kernels.quantize import quantize as q

    w = torch.zeros(2, q.LANES)
    out = q.qdq_rows_rng(w, (0, 0), torch.ones(2), torch.ones(2), bits=8)
    assert out is not w and out.device.type == "cpu"
    meta = [t.to("meta") for t in (w, torch.ones(2), torch.ones(2))]
    q.reset_launch_counts()
    out = q.qdq_rows_rng(meta[0], (0, 0), meta[1], meta[2], bits=8)
    assert out.device.type == "meta" and out.shape == w.shape
    out = q.qdq_delta_rows_rng(meta[0], torch.empty_like(meta[0]), (0, 0), meta[1], meta[2],
                               bits=8)
    assert out.device.type == "meta" and out.shape == w.shape
    assert not any(q.LAUNCHES.values())
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="CPU, CUDA or meta"):
        q.qdq_rows_rng(other, (0, 0), meta[1], meta[2], bits=8)
    with pytest.raises(ValueError, match="CPU, CUDA or meta"):
        q.qdq_delta_rows_rng(other, meta[0], (0, 0), meta[1], meta[2], bits=8)


def test_block_attention_on_cpu_never_touches_the_kernel():
    """A CPU tensor takes the plain version: the launch counter stays put and
    nothing is built; the kernel's own wrapper refuses a CPU tensor."""
    from repro_torch.kernels.block_attn import block_attention
    from repro_torch.kernels.block_attn import block_attn as bk

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 20, heads, 8, generator=gen) for heads in (4, 2, 2))
    bk.reset_launch_counts()
    o = block_attention(q, k, v, window=5)
    assert o.shape == q.shape and torch.isfinite(o).all()
    assert bk.LAUNCHES == {"block_attn": 0} and bk.BUILD_INFO == {}
    with pytest.raises(ValueError, match="CUDA"):
        bk.block_attn(q, k, v)


def test_ssd_chunked_on_cpu_never_touches_the_kernel():
    """A CPU tensor takes the plain version: the launch counter stays put and
    nothing is built; the kernel's own wrapper refuses a CPU tensor."""
    from repro_torch.kernels.ssd_scan import ssd_chunked
    from repro_torch.kernels.ssd_scan import ssd_scan as sk

    gen = torch.Generator().manual_seed(0)
    x, bb, cc = (torch.randn(1, 2, 20, 8, generator=gen), torch.randn(1, 1, 20, 4, generator=gen),
                 torch.randn(1, 1, 20, 4, generator=gen))
    dt, a_log = torch.rand(1, 2, 20, generator=gen), torch.zeros(2)
    sk.reset_launch_counts()
    y = ssd_chunked(x, dt, a_log, bb, cc, chunk=8)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert sk.LAUNCHES == {"ssd_scan": 0} and sk.BUILD_INFO == {}
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd_scan(x, dt, a_log, bb, cc, chunk=8)


def _wire_calls(q, device):
    """Each of the six wire wrappers with (R, 128) operands on ``device``."""
    w, u, base = (torch.full((2, q.LANES), v, device=device) for v in (0.5, 0.25, 1.0))
    s, n = torch.full((2,), 0.1, device=device), torch.ones(2, device=device)
    idx = torch.ones(2, q.LANES, dtype=torch.int8, device=device)
    norm = torch.ones((), device=device)
    return {
        "qdq_delta_rows": lambda: q.qdq_delta_rows(w.clone(), base, u, s, n, bits=8),
        "qdq_rows": lambda: q.qdq_rows(w.clone(), u, s, n, bits=8),
        "quantize_rows": lambda: q.quantize_rows(w, u, s, n, bits=8),
        "dequantize_rows": lambda: q.dequantize_rows(idx, s, n),
        "quantize": lambda: q.quantize(w, u, norm, s=0.1, bits=8),
        "dequantize": lambda: q.dequantize(idx, norm, s=0.1, out_dtype=torch.bfloat16),
    }


@pytest.mark.parametrize("name", ["qdq_delta_rows", "qdq_rows", "quantize_rows",
                                  "dequantize_rows", "quantize", "dequantize"])
def test_wire_wrappers_take_the_plain_path_only_on_the_cpu(name):
    """A CPU tensor takes the plain version (no build, no launch), and so
    does a meta tensor, shape-only (the dry run's count); a tensor on any
    other device is refused."""
    from unittest import mock

    from repro_torch.kernels.quantize import quantize as q

    q.reset_launch_counts()
    out = _wire_calls(q, "cpu")[name]()
    assert out.device.type == "cpu" and out.shape == (2, q.LANES)
    out = _wire_calls(q, "meta")[name]()
    assert out.device.type == "meta" and out.shape == (2, q.LANES)
    assert not any(q.LAUNCHES.values()) and name in q.LAUNCHES and q.BUILD_INFO == {}
    calls = _wire_calls(q, "meta")
    with mock.patch.object(torch.Tensor, "device", torch.device("xpu")), \
            pytest.raises(ValueError, match="CPU, CUDA or meta"):
        calls[name]()
