"""The port's dry run (``repro_torch.launch.dryrun``: one rank's program on
meta tensors, shape-only mesh axes) against the JAX package's
``repro.launch.dryrun``, on the CPU, with no card.

Contracts:
- ``SHAPES`` and ``LONG_CTX_WINDOW`` equal; ``resolve_cfg``,
  ``optimize_cfg`` (environment unset) and ``scaled_cfg(., 2 and 3)`` equal
  field by field for every arch x shape; ``input_specs`` gives the
  reference's tree, shapes and dtypes for every arch x shape (the
  long_500k ring cache included); ``model_flops_estimate`` within rtol 1e-12.
- FLOPs: on the reference's tiny config (tests/test_dryrun.py) the counted
  forward equals the closed form, 2 m n k for every product with the full
  L x L scores; the train step's count stands within ``XLA_BAND`` of XLA's
  ``flops`` for the reference's unrolled tiny train program on one device
  (the port counts the products alone, each forward twice under remat;
  XLA counts element-wise ops too); counts at 2 and 3 blocks extrapolate to
  the whole depth's exactly (flops, bytes and collective bytes).
- collectives: the shape-only axes' calls and bytes per rank equal what
  ``MeshAxis.stats`` counts for the same program on a real 2-rank gloo
  group: train at (1, 2) and (2, 1), the ``slots=False`` decode at (1, 2),
  and the gossip at 2 pods, bits 32 and 8 (which moves only pod-axis
  exchanges).
- ``make_serve_step(slots=False)`` against the reference's on a SMOKE
  config at one device: logits and cache within 1e-4 (the port's
  decode-vs-JAX tolerance, tests/test_torch_serve.py).
- the CLI exits 0 on the CPU and its JSON has the reference's keys.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch import dryrun as JD
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JArch

from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.dist import make_serve_step
from repro_torch.launch import dryrun as D
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from _torch_threads import torch_threads  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
COMBOS = [(a, s) for a in ARCH_IDS for s in D.SHAPES]
TINY = dict(name="tiny", n_layers=6, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
            vocab=512)
TINY_SHAPES = {"tiny_train": dict(kind="train", seq_len=128, global_batch=16),
               "tiny_decode": dict(kind="decode", seq_len=128, global_batch=16)}
# The port's train-step FLOPs over XLA's for the tiny program: measured
# 0.8972 (17,716,740,096 against 19,745,843,200; products only, with the
# remat's second forward, against XLA's products and element-wise ops).
XLA_BAND = (0.87, 0.92)
RESULT_KEYS = {"arch", "shape", "mesh", "fed", "opt", "sliding_window", "params_b",
               "active_params_b", "bytes_per_device", "roofline", "lower_compile_s"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant", "hlo_flops_per_chip",
                 "hlo_bytes_per_chip", "collective_bytes_per_chip", "model_flops",
                 "useful_flops_ratio", "collectives"}


@pytest.fixture
def tiny_shapes(monkeypatch):
    for k, v in TINY_SHAPES.items():
        monkeypatch.setitem(D.SHAPES, k, v)
        monkeypatch.setitem(JD.SHAPES, k, v)


def _asdict(cfg):
    return dataclasses.asdict(cfg)


def test_shapes_and_window_equal():
    assert D.SHAPES == JD.SHAPES
    assert D.LONG_CTX_WINDOW == JD.LONG_CTX_WINDOW


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_configs_equal(arch, shape, monkeypatch):
    for var in ("REPRO_OPT_MOE_GS", "REPRO_OPT_BF16_SCORES"):
        monkeypatch.delenv(var, raising=False)
    cfg, jcfg = D.resolve_cfg(arch, shape), JD.resolve_cfg(arch, shape)
    assert _asdict(cfg) == _asdict(jcfg)
    assert _asdict(D.optimize_cfg(cfg)) == _asdict(JD.optimize_cfg(jcfg))
    for k in (2, 3):
        assert _asdict(D.scaled_cfg(cfg, k)) == _asdict(JD.scaled_cfg(jcfg, k))
    np.testing.assert_allclose(D.model_flops_estimate(cfg, shape),
                               JD.model_flops_estimate(jcfg, shape), rtol=1e-12)


def test_optimize_cfg_reads_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_OPT_MOE_GS", "256")
    monkeypatch.setenv("REPRO_OPT_BF16_SCORES", "1")
    for arch in ARCH_IDS:
        cfg = D.resolve_cfg(arch, "train_4k")
        assert _asdict(D.optimize_cfg(cfg)) == _asdict(
            JD.optimize_cfg(JD.resolve_cfg(arch, "train_4k")))


def _paths(tree):
    """path -> leaf of a nested dict/list/tuple."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out["/".join(map(str, path))] = node
    walk(tree, ())
    return out


def _specs(tree):
    """path -> (shape, dtype name) of a tree of tensors or ShapeDtypeStructs."""
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in _paths(tree).items()}


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_input_specs_equal(arch, shape):
    cfg, jcfg = D.resolve_cfg(arch, shape), JD.resolve_cfg(arch, shape)
    got, want = D.input_specs(cfg, shape), JD.input_specs(jcfg, shape)
    assert _specs(got) == _specs(want)
    assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    slot0 = got["cache"]["slots"]["slot0"] if "cache" in got else {}
    if shape == "long_500k" and cfg.sliding_window and "k" in slot0:
        assert slot0["k"].shape[2] == D.LONG_CTX_WINDOW     # the ring buffer


def test_input_specs_fed_groups():
    cfg = D.resolve_cfg("yi-6b", "train_4k")
    assert _specs(D.input_specs(cfg, "train_4k", fed_groups=2)) == _specs(
        JD.input_specs(JD.resolve_cfg("yi-6b", "train_4k"), "train_4k", fed_groups=2))


# -------------------------------------------------------------------- FLOPs
def test_forward_flops_closed_form():
    """Every product of the tiny forward, 2 m n k each, the L x L scores
    and the probabilities-times-values included; nothing else."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = ArchConfig(**TINY)
    b, s = 16, 128
    t, d, h, kv, ff, v = b * s, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab
    hd = d // h
    per_layer = (2 * t * d * h * hd            # q
                 + 2 * 2 * t * d * kv * hd     # k, v
                 + 2 * b * h * s * s * hd      # scores
                 + 2 * b * h * s * s * hd      # probabilities x values
                 + 2 * t * h * hd * d          # output projection
                 + 3 * 2 * t * d * ff)         # SwiGLU gate, up, down
    want = cfg.n_layers * per_layer + 2 * t * d * v
    params = T.abstract_params(cfg)
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        logits, _ = T.forward_train(cfg, params, tokens, remat=False)
    assert logits.shape == (b, s, v) and logits.device.type == "meta"
    assert counter.get_total_flops() == want


def test_train_flops_within_band_of_xla(tiny_shapes):
    """The train step at one rank against XLA's count of the reference's
    unrolled tiny train program on a one-device mesh."""
    from jax.sharding import Mesh

    cfg = ArchConfig(**TINY)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jcfg = JArch(**TINY)
    compiled = JD._lower_combo(jcfg, "tiny_train", jmesh, fed=False, unroll=True)
    xla = JD._raw_costs(compiled)["flops"]
    got = D.costs(cfg, "tiny_train", D.ShapeMesh(1, 1))["flops"]
    ratio = got / xla
    assert XLA_BAND[0] <= ratio <= XLA_BAND[1], (got, xla, ratio)


@pytest.mark.parametrize("shape,mesh", [("tiny_train", (4, 4)), ("tiny_train", (2, 1)),
                                        ("tiny_decode", (4, 4))])
def test_block_counts_extrapolate_to_the_whole_depth(tiny_shapes, shape, mesh):
    """C(n) = C(2) + (n - 2) (C(3) - C(2)), exactly: every block adds the
    same count (the port's form of the scan correction's check)."""
    cfg = ArchConfig(**TINY)
    full, c2, c3 = (D.costs(c, shape, D.ShapeMesh(*mesh))
                    for c in (cfg, D.scaled_cfg(cfg, 2), D.scaled_cfg(cfg, 3)))
    n = cfg.n_blocks
    for key in ("flops", "bytes"):
        assert full[key] == c2[key] + (n - 2) * (c3[key] - c2[key]), key
    assert full["coll"]["total"] == c2["coll"]["total"] + (n - 2) * (
        c3["coll"]["total"] - c2["coll"]["total"])
    assert full["flops"] > 0 and full["bytes"] > 0


def test_memory_counts(tiny_shapes):
    """Arguments are exact; the peak holds the arguments and the program's
    own storage; a decode step's output cache replaces its input's."""
    cfg = ArchConfig(**TINY)
    fn, args = D.build_program(cfg, "tiny_decode", D.ShapeMesh(1, 1))
    want = sum(t.numel() * t.element_size() for t in jax.tree_util.tree_leaves(
        args, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    res = D.measure(fn, args, [])
    mem = res["memory"]
    assert mem["argument"] == want
    assert mem["peak"] == mem["argument"] + mem["temp"] and mem["temp"] > 0
    assert mem["output"] > 0


# -------------------------------------------------------------- collectives
_WORKER = textwrap.dedent("""
    import datetime, json, os, sys
    rank, world, init, out, src = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                   sys.argv[4], sys.argv[5])
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh, make_pod_mesh
    from repro_torch.models.config import ArchConfig
    D.SHAPES.update(json.loads(sys.argv[6]))
    cfg = ArchConfig(**json.loads(sys.argv[7]))
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    cpu = torch.device("cpu")
    res = {}
    try:
        for name, shape, mesh_shape, bits in json.loads(sys.argv[8]):
            if bits is None:
                mesh = make_host_mesh(*mesh_shape, device=cpu, group=dist.group.WORLD)
                axes = [mesh.axis, mesh.data_axis]
            else:
                mesh = make_pod_mesh(2, device=cpu, group=dist.group.WORLD)
                axes = [mesh.gossip_axis, mesh.pod_axis]
            fn, args = D.build_program(cfg, shape, mesh, fed=bits is not None, device=cpu,
                                       gossip_bits=bits)
            for a in axes:
                a.stats.update(calls=0, bytes=0, seconds=0.0)
            fn(*args)
            res[name] = {a.name: [a.stats["calls"], a.stats["bytes"]] for a in axes}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
""")

COLL_CASES = [  # name, shape, (data, model) or None, gossip bits or None
    ("train_1x2", "tiny_train", (1, 2), None),
    ("train_2x1", "tiny_train", (2, 1), None),
    ("decode_1x2", "tiny_decode", (1, 2), None),
    ("gossip_32", "tiny_train", None, 32),
    ("gossip_8", "tiny_train", None, 8),
]


@pytest.fixture(scope="module")
def gloo_stats(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_gloo")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    args = [str(out / "init"), str(out), os.path.join(ROOT, "src"), json.dumps(TINY_SHAPES),
            json.dumps(TINY), json.dumps(COLL_CASES)]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "2", *args], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    return [json.load(open(out / f"rank{r}.json")) for r in range(2)]


@pytest.mark.parametrize("name,shape,mesh_shape,bits", COLL_CASES)
def test_shape_axes_count_as_the_real_group(gloo_stats, tiny_shapes, name, shape,
                                            mesh_shape, bits):
    cfg = ArchConfig(**TINY)
    mesh = D.ShapeMesh(*mesh_shape) if bits is None else D.ShapePodMesh(2, 1, 1)
    fn, args = D.build_program(cfg, shape, mesh, fed=bits is not None, gossip_bits=bits)
    res = D.measure(fn, args, mesh.axes())
    got = {a.name: [a.stats["calls"], a.stats["bytes"]] for a in mesh.axes()}
    for rank in range(2):
        assert gloo_stats[rank][name] == got, (rank, name)
    assert sum(c for c, _ in got.values()) > 0
    if bits is not None:
        # the DFedRW gossip: pod-axis exchanges only, no gather, no sum
        assert set(res["calls"]) == {"gossip/exchange"}
        assert res["calls"]["gossip/exchange"] == 1        # ring of 2 pods: one offset
        leaves = [p.numel() for p in jax.tree_util.tree_leaves(
            args, is_leaf=lambda x: isinstance(x, torch.Tensor))]
        per_elem = 1 if bits < 32 else 4
        header = 8 * len(leaves) if bits < 32 else 0
        assert res["coll"]["gossip/exchange"] == per_elem * sum(leaves) + header


def test_production_gossip_is_exchanges_only(monkeypatch):
    """The multi-pod --fed program on the (2, 16, 16) mesh at bits 8: only
    pod-axis exchanges, whose bytes are the int8 wire of the rank's blocks
    (one code a live element, one float32 s and norm a leaf)."""
    monkeypatch.setenv("REPRO_FED_BITS", "8")
    res = D.dryrun_one("mamba2-130m", "train_4k", multi_pod=True, fed=True, verbose=False)
    assert set(res["collective_calls"]) == {"gossip/exchange"}
    cfg = D.resolve_cfg("mamba2-130m", "train_4k")
    mesh = D.ShapePodMesh(2, 16, 16)
    base = T.abstract_params(cfg, torch.float32)
    from repro_torch.dist.sharding import param_specs, shard_tree
    blocks = jax.tree_util.tree_leaves(shard_tree(base, param_specs(base, mesh), mesh, 0),
                                       is_leaf=lambda x: isinstance(x, torch.Tensor))
    want = sum(b.numel() for b in blocks) + 8 * len(blocks)
    assert res["roofline"]["collectives"] == {"gossip/exchange": float(want)}


# -------------------------------------------------------- the decode step
@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-130m"])
def test_serve_step_lockstep_matches_reference(arch):
    from jax.sharding import Mesh
    from repro.dist.steps import make_serve_step as j_make_serve_step

    cfg, jcfg = get_smoke(arch), j_configs.get_smoke(arch)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    b, length = 2, 16
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jserve, _ = j_make_serve_step(jcfg, jmesh, slots=False)
    serve = make_serve_step(cfg, slots=False)
    jcache = JT.init_cache(jcfg, b, length, jnp.float32)
    cache = T.init_cache(cfg, b, length, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(3, b, 1))
    for tok in toks:
        jlogits, jcache = jserve(jparams, jcache, jnp.asarray(tok, jnp.int32))
        logits, cache = serve(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    assert int(cache["pos"]) == int(jcache["pos"]) == 3
    want = {k: np.asarray(v) for k, v in _paths(jcache).items()}
    got = _paths(cache)
    assert set(got) == set(want)
    for key, leaf in got.items():
        np.testing.assert_allclose(leaf.numpy(), want[key], atol=1e-4, rtol=1e-4,
                                   err_msg=key)


# --------------------------------------------------------------------- CLI
def test_cli_single_combo(tmp_path):
    out = tmp_path / "out.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "mamba2-130m", "--shape", "decode_32k", "--json", str(out)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    res = json.loads(out.read_text())[0]
    assert RESULT_KEYS <= set(res) and ROOFLINE_KEYS <= set(res["roofline"])
    assert set(res["bytes_per_device"]) == {"argument", "output", "temp", "peak"}
    assert res["mesh"] == "16x16"
    rl = res["roofline"]
    assert rl["hlo_flops_per_chip"] > 0
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert set(rl["collectives"]) <= {"model/gather", "data/gather"}
    assert "jax" not in r.stdout


def test_cli_reports_failures_and_exits_1(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "yi-6b", "--shape", "decode_32k", "--fed"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 1
    assert "!! FAIL yi-6b x decode_32k: ValueError" in r.stdout
