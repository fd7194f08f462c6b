"""Data-parallel serving slots on the CPU: the port's ``ServeEngine`` on a
``(data=2, model=1)`` mesh over two ``torch.distributed`` processes and on a
``(data=2, model=2)`` mesh over four (``launch.mesh.make_host_mesh``; gloo,
``file://`` init, one thread each), against the unsharded port engine and
the JAX ``ServeEngine`` on the same weights and requests; and
``launch.serve --mesh-model 1 --device cpu`` under ``torchrun``.

Weights are the reference's ``init_params(PRNGKey(3), float32)``, carried
across with ``lm_params_from_numpy``; each rank's engine cuts its block on
the model axis and keeps the weights whole along the data axis. The
workload is ``launch.serve.build_requests``'s from one seed (mixed
lengths, Poisson arrivals). The JAX engine runs on a one-device mesh of
automatic axes (``jax.sharding.Mesh``), as ``tests/test_torch_serve.py``
builds it. Each rank runs every family three ways: greedy on 4 slots (2 a
data rank), sampled (temperature > 0) on 4 slots, and greedy on 3 slots,
which the data axis does not divide (every rank then holds every slot).

Contracts, each case a test of its own:
- each request's greedy token stream equals the unsharded port engine's
  and the JAX engine's, a difference allowed only at a near-tie (a top-2
  logit gap below ``FLIP_GAP`` in the sequential decode), and every
  ``EngineMetrics`` counter equals the unsharded engine's;
- every rank of the mesh ends ``run`` with the same digest and holds the
  same tokens; the split slots cross the data axis (and the model axis at
  (2, 2)), each data rank holding 2 of the 4 rows;
- sampled from the same seed, the streams are the unsharded port
  engine's: each rank draws the whole batch's noise and takes its rows;
- on 3 slots every rank holds rows [0, 3), no token crosses the data axis,
  and the tokens and counters are the unsharded 3-slot engine's;
- Seamless's encoder runs once an admission across the data ranks (on
  each model rank of the data row that holds the slot), and on every rank
  when the slots are replicated;
- the launcher serves on a (2, 1) mesh and passes ``--verify``, with
  imports of jax and repro refused (``tests/test_torch_isolation.py``'s
  guard); a world of 4 with ``--mesh-model 3`` exits naming the mesh.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from repro import configs as j_configs
from repro.models import transformer as JT
from repro.serve import EngineConfig as JEngineConfig, ServeEngine as JServeEngine
from repro.serve import scheduler as j_sched

from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as launch
from repro_torch.serve import EngineConfig, ServeEngine
from _torch_threads import torch_threads  # noqa: F401
from test_torch_isolation import _GUARD

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLIP_GAP = 1e-5                # chip_smoke.py's near-tie gap
ARCHS = ("mamba2-130m", "yi-6b", "granite-34b", "seamless-m4t-large-v2",
         "jamba-1.5-large-398b", "deepseek-v2-lite-16b")
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}
ENGINE = dict(max_concurrency=4, max_len=16, chunk=4)
RUNS = {"greedy": (ENGINE, 0.0), "sampled": (dict(ENGINE, seed=5), 0.8),
        "replicated": (dict(ENGINE, max_concurrency=3), 0.0)}
WORKLOAD = dict(seed=0, requests=8, prompt_len=8, gen=8, mixed=True, arrival=0.5, eos_id=-1)

_WORKER = textwrap.dedent("""
    import json, os, sys
    rank, world, init, out, src = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                   sys.argv[4], sys.argv[5])
    sys.path.insert(0, src)
    import argparse
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import serve as launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig, ServeEngine

    spec = json.load(open(os.path.join(out, "spec.json")))

    def unflatten(flat):
        tree = {}
        for key, value in flat.items():
            node = tree
            *parts, last = key.split("/")
            for part in parts:
                node = node.setdefault(part, {})
            node[last] = value
        return tree

    encoder_calls = [0]
    real_encoder = T._run_encoder

    def counted_encoder(*args, **kwargs):
        encoder_calls[0] += 1
        return real_encoder(*args, **kwargs)

    T._run_encoder = counted_encoder
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(2, world // 2, device=torch.device("cpu"), group=dist.group.WORLD)
        res = {"coords": [mesh.data_axis.rank, mesh.axis.rank]}
        for arch in spec["archs"]:
            cfg = get_smoke(arch)
            tree = unflatten(dict(np.load(os.path.join(out, f"{arch}.npz"))))
            for run, (engine, temperature) in spec["runs"].items():
                reqs = launch.build_requests(
                    argparse.Namespace(**spec["workload"], temperature=temperature), cfg)
                eng = ServeEngine(cfg, lm_params_from_numpy(tree, "cpu"),
                                  EngineConfig(**engine), mesh=mesh, margins=run == "greedy")
                calls = {name: axis.stats["calls"] for name, axis in
                         (("data", mesh.data_axis), ("model", mesh.axis))}
                encoder_calls[0] = 0
                done = eng.run(reqs)
                res[f"{arch}/{run}"] = {
                    "tokens": {st.request.rid: st.generated for st in done},
                    "stops": {st.request.rid: st.stop for st in done},
                    "margins": eng.margins, "digest": eng.digest,
                    "rows": [eng.rows.start, eng.rows.stop],
                    "encoder_calls": encoder_calls[0],
                    "collectives": {name: axis.stats["calls"] - calls[name] for name, axis in
                                    (("data", mesh.data_axis), ("model", mesh.axis))},
                    "counters": {k: v for k, v in eng.metrics.summary().items()
                                 if not k.endswith("_s") and "tok_s" not in k}}
        json.dump(res, open(os.path.join(out, f"rank{rank}.json"), "w"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
""")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _requests(cfg, temperature=0.0):
    return launch.build_requests(argparse.Namespace(**WORKLOAD, temperature=temperature), cfg)


def _j_requests(reqs):
    return [j_sched.Request(rid=r.rid, prompt=r.prompt, max_tokens=r.max_tokens,
                            eos_id=r.eos_id, temperature=r.temperature,
                            arrival_step=r.arrival_step, embeds=r.embeds) for r in reqs]


def _counters(eng):
    return {k: v for k, v in eng.metrics.summary().items()
            if not k.endswith("_s") and "tok_s" not in k}


def _spawn(world, out):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), str(world),
                              str(out / "init"), str(out), os.path.join(ROOT, "src")],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(world)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """({arch: (JAX greedy tokens, {run: (unsharded engine, its results)},
    params)}, {mesh: [each rank's results]}): the ranks of both meshes run
    while the JAX engine and the unsharded port engine run here."""
    outs = {name: tmp_path_factory.mktemp(f"serve_dp{name}") for name in MESHES}
    trees = {arch: jax.tree_util.tree_map(
        np.array, JT.init_params(j_configs.get_smoke(arch), jax.random.PRNGKey(3),
                                 jnp.float32)) for arch in ARCHS}
    for out in outs.values():
        for arch, tree in trees.items():
            np.savez(out / f"{arch}.npz", **_flatten(tree))
        (out / "spec.json").write_text(json.dumps({"archs": ARCHS, "workload": WORKLOAD,
                                                   "runs": RUNS}))
    procs = {name: _spawn(data * model, outs[name]) for name, (data, model) in MESHES.items()}
    try:
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
        local = {}
        for arch in ARCHS:
            jcfg, cfg = j_configs.get_smoke(arch), configs.get_smoke(arch)
            jdone = JServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, trees[arch]),
                                 JEngineConfig(**ENGINE), mesh=mesh).run(
                _j_requests(_requests(cfg)))
            params = lm_params_from_numpy(trees[arch], "cpu")
            runs = {}
            for run, (engine, temperature) in RUNS.items():
                eng = ServeEngine(cfg, params, EngineConfig(**engine), device="cpu",
                                  margins=run == "greedy")
                runs[run] = (eng, eng.run(_requests(cfg, temperature)))
            local[arch] = ({st.request.rid: st.generated for st in jdone}, runs, params)
        errors = []
        for name, group in procs.items():
            for rank, proc in enumerate(group):
                _, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    errors.append(f"{name} rank {rank}: {err[-3000:]}")
    finally:
        for group in procs.values():
            for proc in group:
                proc.kill()
    assert not errors, "\n".join(errors)
    ranks = {name: [json.loads((outs[name] / f"rank{rank}.json").read_text())
                    for rank in range(data * model)]
             for name, (data, model) in MESHES.items()}
    return local, ranks


def _same_up_to_near_tie(cfg, params, req, got, want):
    """Equal streams, or equal up to a first difference where the
    sequential decode's top-2 logit gap is below FLIP_GAP."""
    if got == want:
        return True
    gaps = []
    seq = launch.sequential_reference(cfg, params, req, ENGINE["max_len"], "cpu", gaps)
    first = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    return seq[:first] == got[:first] and gaps[first] < FLIP_GAP


def _tokens(rank_res):
    return {int(rid): toks for rid, toks in rank_res["tokens"].items()}


def _check_greedy(local, rank_res, arch, run):
    want_jax, runs, params = local[arch]
    eng, done = runs[run]
    cfg = configs.get_smoke(arch)
    got = _tokens(rank_res)
    assert sorted(got) == [st.request.rid for st in done]
    for st in done:
        rid = st.request.rid
        for want in (st.generated, want_jax[rid]):
            assert _same_up_to_near_tie(cfg, params, st.request, got[rid], want), \
                (rid, got[rid], want)
        assert rank_res["stops"][str(rid)] == st.stop
    assert rank_res["counters"] == _counters(eng)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_data_parallel_engine_serves_the_unsharded_tokens(served, mesh, arch):
    """Rank 0's greedy streams and counters, and the top-2 margins that every
    token was taken from (gathered over the data axis with the tokens), to
    the stream's first difference within 1e-4 of the unsharded ones."""
    local, ranks = served
    res = ranks[mesh][0][f"{arch}/greedy"]
    _check_greedy(local, res, arch, "greedy")
    assert res["counters"]["prefill_chunks"] > 0 and res["counters"]["decode_steps"] > 0
    eng, done = local[arch][1]["greedy"]
    for st in done:
        got = _tokens(res)[st.request.rid]
        same = next((i for i, (a, b) in enumerate(zip(got, st.generated)) if a != b), len(got))
        want = np.array(eng.margins[st.request.rid][:same])
        assert same > 0 and want.shape == (same, 2)
        np.testing.assert_allclose(res["margins"][str(st.request.rid)][:same], want,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_ranks_agree_and_split_the_slots(served, mesh, arch):
    """Every rank ends with the same digest and tokens; data rank d holds
    rows [2d, 2d + 2) of the 4 slots, and every step's tokens cross the data
    axis (the heads the model axis at (2, 2))."""
    _, ranks = served
    data, model = MESHES[mesh]
    runs = [rank[f"{arch}/greedy"] for rank in ranks[mesh]]
    assert len({r["digest"] for r in runs}) == 1 and runs[0]["digest"] is not None
    assert all(r["tokens"] == runs[0]["tokens"] for r in runs)
    for rank, r in zip(ranks[mesh], runs):
        d, m = rank["coords"]
        assert r["rows"] == [2 * d, 2 * d + 2]
        steps = r["counters"]["prefill_chunks"] + r["counters"]["decode_steps"]
        assert r["collectives"]["data"] == steps
        assert (r["collectives"]["model"] > 0) == (model > 1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_sampled_streams_are_the_unsharded_ones(served, mesh, arch):
    """Temperature 0.8 from the same seed: every rank draws the whole
    batch's noise from the seeded generator and takes its rows, so the
    streams are the unsharded engine's."""
    local, ranks = served
    eng, done = local[arch][1]["sampled"]
    assert all(st.request.temperature > 0 for st in done)
    for rank in ranks[mesh]:
        res = rank[f"{arch}/sampled"]
        assert _tokens(res) == {st.request.rid: st.generated for st in done}
        assert res["counters"] == _counters(eng)
    assert len({rank[f"{arch}/sampled"]["digest"] for rank in ranks[mesh]}) == 1


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_indivisible_slots_are_replicated(served, mesh, arch):
    """3 slots at data = 2: every rank holds and runs every row, no token
    crosses the data axis, and the streams and counters are the unsharded
    3-slot engine's."""
    local, ranks = served
    for rank in ranks[mesh]:
        res = rank[f"{arch}/replicated"]
        assert res["rows"] == [0, 3] and res["collectives"]["data"] == 0
        _check_greedy(local, res, arch, "replicated")
    assert len({rank[f"{arch}/replicated"]["digest"] for rank in ranks[mesh]}) == 1


@pytest.mark.parametrize("mesh", MESHES)
def test_encoder_runs_once_per_admission(served, mesh):
    """Seamless: each admission runs the encoder on the data row that holds
    the slot (each of its model ranks), so the data ranks of one model index
    run it once a request between them; on 3 replicated slots every rank
    runs it for every request."""
    _, ranks = served
    arch = "seamless-m4t-large-v2"
    n = WORKLOAD["requests"]
    by_model = {}
    for rank in ranks[mesh]:
        by_model.setdefault(rank["coords"][1], []).append(rank[f"{arch}/greedy"]["encoder_calls"])
        assert rank[f"{arch}/replicated"]["encoder_calls"] == n
    assert all(sum(calls) == n and min(calls) > 0 for calls in by_model.values())
    assert len(by_model) == MESHES[mesh][1]


def _torchrun(tmp_path, nproc, *args, timeout=300):
    (tmp_path / "sitecustomize.py").write_text(_GUARD)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(tmp_path), os.path.join(ROOT, "src")]))
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(nproc), "-m", "repro_torch.launch.serve", "--device", "cpu", *args],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=timeout)


def test_launcher_serves_data_parallel_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh-model 1
    --device cpu --verify``, jax and repro refused: both ranks on a (2, 1)
    mesh over gloo, equal digests, each step's tokens gathered over the data
    axis, the verification against the unsharded sequential decode
    passes."""
    proc = _torchrun(tmp_path, 2, "--arch", "yi-6b", "--smoke", "--mesh-model", "1",
                     "--requests", "5", "--max-concurrency", "4", "--prompt-len", "6",
                     "--gen", "4", "--mixed", "--verify")
    out = proc.stdout
    assert proc.returncode == 0, out[-2000:] + proc.stderr[-3000:]
    assert "verify: all 5 requests identical" in out
    assert sorted(re.findall(r"rank (\d): backend=gloo mesh=\{'data': 2, 'model': 1\}", out)) \
        == ["0", "1"]
    digests = dict(re.findall(r"rank (\d): digest=(\w+)", out))
    assert sorted(digests) == ["0", "1"] and len(set(digests.values())) == 1
    timing = [json.loads(t) for t in re.findall(r"rank \d: timing (.*)", out)]
    assert len(timing) == 2
    for t in timing:
        for kind in ("decode", "prefill"):
            assert t[kind]["axes"]["data"]["calls"] == 1, t
            assert t[kind]["axes"]["model"]["calls"] == 0, t


def test_launcher_exits_where_the_model_axis_does_not_divide_the_world(tmp_path):
    proc = _torchrun(tmp_path, 4, "--arch", "mamba2-130m", "--mesh-model", "3", timeout=120)
    assert proc.returncode != 0
    assert "--mesh-model 3 over 4 ranks" in proc.stderr and "does not divide 4" in proc.stderr
