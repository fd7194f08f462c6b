"""Tensor-parallel serving on the CPU: the port's ``ServeEngine`` on a
``(data=1, model=2)`` mesh (``launch.mesh.make_host_mesh``) over two
``torch.distributed`` processes (gloo, ``file://`` init, one thread each),
against the unsharded port engine and the JAX ``ServeEngine`` on the same
weights and requests; and ``launch.serve --mesh-model 2 --device cpu``
under ``torchrun``.

Weights are the reference's ``init_params(PRNGKey(3), float32)``, carried
across with ``lm_params_from_numpy``; each rank's engine cuts its own block
(``param_specs``). The workload is ``launch.serve.build_requests``'s from
one seed (mixed lengths, Poisson arrivals). The JAX engine runs on a
one-device mesh of automatic axes (``jax.sharding.Mesh``), as
``tests/test_torch_serve.py`` builds it.

Contracts:
- each request's token stream equals the unsharded port engine's and the
  JAX engine's, a difference allowed only at a near-tie (a top-2 logit gap
  below ``FLIP_GAP`` in the sequential decode), and every ``EngineMetrics``
  counter and request step equal the unsharded engine's;
- both ranks end ``run`` with the same digest of their token streams, and
  hold the same tokens;
- the launcher serves and passes ``--verify`` against the unsharded
  sequential decode, each rank printing its backend (gloo), its timing line
  and its digest, with imports of jax and repro refused in ``torchrun`` and
  its ranks (``tests/test_torch_isolation.py``'s guard, as a
  ``sitecustomize``); without ``torchrun`` it refuses ``--mesh-model 2``.
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
WORLD = 2
FLIP_GAP = 1e-5                # chip_smoke.py's near-tie gap
ARCHS = ("yi-6b", "granite-34b", "seamless-m4t-large-v2", "jamba-1.5-large-398b",
         "deepseek-v2-lite-16b")
ENGINE = dict(max_concurrency=4, max_len=16, chunk=4)
WORKLOAD = dict(seed=0, requests=8, prompt_len=8, gen=8, mixed=True, arrival=0.5, eos_id=-1,
                temperature=0.0)

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

    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    try:
        group = dist.group.WORLD
        mesh = make_host_mesh(1, world, device=torch.device("cpu"), group=group)
        res = {}
        for arch in spec["archs"]:
            cfg = get_smoke(arch)
            params = lm_params_from_numpy(
                unflatten(dict(np.load(os.path.join(out, f"{arch}.npz")))), "cpu")
            reqs = launch.build_requests(argparse.Namespace(**spec["workload"]), cfg)
            eng = ServeEngine(cfg, params, EngineConfig(**spec["engine"]), mesh=mesh)
            done = eng.run(reqs)
            res[arch] = {"tokens": {st.request.rid: st.generated for st in done},
                         "stops": {st.request.rid: st.stop for st in done},
                         "digest": eng.digest, "collectives": eng.axis.stats["calls"],
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


def _requests(cfg):
    return launch.build_requests(argparse.Namespace(**WORKLOAD), cfg)


def _j_requests(reqs):
    return [j_sched.Request(rid=r.rid, prompt=r.prompt, max_tokens=r.max_tokens,
                            eos_id=r.eos_id, temperature=r.temperature,
                            arrival_step=r.arrival_step, embeds=r.embeds) for r in reqs]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{arch: (JAX engine tokens, unsharded port engine, rank results)}:
    the two ranks run while both unsharded engines run here."""
    out = tmp_path_factory.mktemp("serve_tp")
    trees = {}
    for arch in ARCHS:
        trees[arch] = jax.tree_util.tree_map(
            np.array, JT.init_params(j_configs.get_smoke(arch), jax.random.PRNGKey(3),
                                     jnp.float32))
        np.savez(out / f"{arch}.npz", **_flatten(trees[arch]))
    (out / "spec.json").write_text(json.dumps({"archs": ARCHS, "workload": WORKLOAD,
                                               "engine": ENGINE}))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), str(WORLD),
                               str(out / "init"), str(out), os.path.join(ROOT, "src")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(WORLD)]
    try:
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
        local = {}
        for arch in ARCHS:
            jcfg, cfg = j_configs.get_smoke(arch), configs.get_smoke(arch)
            reqs = _requests(cfg)
            jdone = JServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, trees[arch]),
                                 JEngineConfig(**ENGINE), mesh=mesh).run(_j_requests(reqs))
            params = lm_params_from_numpy(trees[arch], "cpu")
            eng = ServeEngine(cfg, params, EngineConfig(**ENGINE), device="cpu")
            done = eng.run(reqs)
            local[arch] = ({st.request.rid: st.generated for st in jdone}, eng, done, params)
        errors = []
        for rank, proc in enumerate(procs):
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                errors.append(f"rank {rank}: {err[-3000:]}")
    finally:
        for proc in procs:
            proc.kill()
    assert not errors, "\n".join(errors)
    ranks = [json.loads((out / f"rank{rank}.json").read_text()) for rank in range(WORLD)]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_engine_serves_the_unsharded_tokens(served, arch):
    local, ranks = served
    want_jax, eng, done, params = local[arch]
    cfg = configs.get_smoke(arch)
    got = {int(rid): toks for rid, toks in ranks[0][arch]["tokens"].items()}
    assert sorted(got) == [st.request.rid for st in done]
    for st in done:
        rid = st.request.rid
        for want in (st.generated, want_jax[rid]):
            assert _same_up_to_near_tie(cfg, params, st.request, got[rid], want), \
                (rid, got[rid], want)
        assert ranks[0][arch]["stops"][str(rid)] == st.stop
    counters = {k: v for k, v in eng.metrics.summary().items()
                if not k.endswith("_s") and "tok_s" not in k}
    assert ranks[0][arch]["counters"] == counters
    assert counters["prefill_chunks"] > 0 and counters["decode_steps"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_agree_and_communicate(served, arch):
    _, ranks = served
    assert ranks[0][arch]["digest"] == ranks[1][arch]["digest"] is not None
    assert ranks[0][arch]["tokens"] == ranks[1][arch]["tokens"]
    assert min(r[arch]["collectives"] for r in ranks) > 0


def test_launcher_serves_tensor_parallel_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh-model 2
    --device cpu --verify``, jax and repro refused: both ranks on gloo, equal
    digests, the verification against the unsharded sequential decode
    passes."""
    (tmp_path / "sitecustomize.py").write_text(_GUARD)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(tmp_path), os.path.join(ROOT, "src")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.serve", "--arch", "seamless-m4t-large-v2", "--smoke",
         "--device", "cpu", "--mesh-model", "2", "--requests", "5", "--max-concurrency", "3",
         "--prompt-len", "6", "--gen", "4", "--mixed", "--verify"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    out = proc.stdout
    assert proc.returncode == 0, out[-2000:] + proc.stderr[-3000:]
    assert "verify: all 5 requests identical" in out
    assert sorted(re.findall(r"rank (\d): backend=gloo mesh=\{'data': 1, 'model': 2\}", out)) \
        == ["0", "1"]
    digests = dict(re.findall(r"rank (\d): digest=(\w+)", out))
    assert sorted(digests) == ["0", "1"] and len(set(digests.values())) == 1
    timing = [json.loads(t) for t in re.findall(r"rank \d: timing (.*)", out)]
    assert len(timing) == 2 and all(t["decode"]["axes"]["model"]["calls"] > 0 for t in timing)


def test_launcher_refuses_mesh_model_without_its_ranks():
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        launch.main(["--arch", "mamba2-130m", "--device", "cpu", "--mesh-model", "2"])
