"""The port's gossip (``repro_torch.dist.gossip``) against the JAX package's
``repro.dist.gossip``, on the CPU.

The multi-device side runs once, in a subprocess with eight forced host
devices (``_ORACLE``): the reference's ``gossip_mix`` on
``jax.sharding.Mesh(devices[:n], ("pod",))`` and its ``walk_permute_batch``,
on four leaves of a reduced Yi SMOKE tree (a 1-D norm, the embedding and
two layer-stacked leaves)
stacked over eight pods with a per-pod perturbation made with numpy from a
seed. The port takes the stacked placement on the same tree; at bits < 32
its uniforms are the reference's own, ``jax.random.uniform`` of the key
folded by (leaf, offset, pod) at the reference's local block shape, made in
this process.

Contracts, with their tolerances:
- ``GossipConfig.offsets`` and ``mixing_weights`` equal the reference's for
  n = 1..9 and every topology;
- the wire of one tensor: given the reference's (s, norm), B5's plain
  version gives the reference's codes bit for bit; the port's own
  ``_wire_round_trip`` is within one grid cell s*norm of the reference's
  (its norm, a torch sum in another order, within ``NORM_ULPS``);
- ``gossip_mix`` stacked against the reference's: bits 32 within 1e-6 of
  each leaf's largest magnitude; bits 8 within one grid cell times the
  mixing weight an offset (a code can round the other way where the norms
  differ by an ulp), on at most ``FLIP_SHARE`` of the elements, the rest
  within 1e-6;
- ``walk_permute_batch`` equals ``np.roll`` and the reference's.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.quantization import QuantConfig, dequantize as j_dequantize
from repro.core.quantization import quantize as j_quantize
from repro.dist import gossip as jg

from repro_torch.core.flatten import make_flat_spec, tree_leaves
from repro_torch.dist import gossip as tg
from repro_torch.kernels.quantize import quantize as qk
from _torch_threads import torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
PODS = 8
KEY_SEED = 11
TOPOLOGIES = ("ring", "expander", "all")
CASES = [(n, topo, bits) for n in (4, 8) for topo in TOPOLOGIES for bits in (32, 8)]
F32_TOL = 1e-6
NORM_ULPS = 4
FLIP_SHARE = 1e-3

_ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[2])
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_smoke
    from repro.dist.gossip import GossipConfig, gossip_mix, walk_permute_batch
    from repro.models import transformer as T

    cases, walks = eval(sys.argv[3])
    cfg = dataclasses.replace(get_smoke("yi-6b"), d_model=64, d_ff=128, vocab=128)
    full = T.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    slot = full["blocks"]["slot0"]
    base = {"embed": full["embed"], "final_norm": full["final_norm"],
            "blocks": {"slot0": {"mixer": {"wq": slot["mixer"]["wq"]}, "norm1": slot["norm1"]}}}
    leaves, treedef = jax.tree_util.tree_flatten(base)
    stacked = [np.stack([np.asarray(l) * (1 + 0.05 * np.random.default_rng(100 * li + p)
                                          .standard_normal(l.shape)).astype(np.float32)
                         for p in range(8)]) for li, l in enumerate(leaves)]
    out = {f"in{li}": x for li, x in enumerate(stacked)}
    for n, topo, bits in cases:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("pod",))
        tree = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x[:n]) for x in stacked])
        specs = jax.tree_util.tree_map(lambda l: P("pod"), tree)
        cfg_g = GossipConfig(topology=topo, quant_bits=bits)
        mixed = jax.jit(lambda t, k: gossip_mix(t, specs, mesh, cfg_g, k))(
            tree, jax.random.PRNGKey(%(key)d))
        for li, x in enumerate(jax.tree_util.tree_leaves(mixed)):
            out[f"mix_{n}_{topo}_{bits}_{li}"] = np.asarray(x)
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("pod",))
    tree = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in stacked])
    specs = jax.tree_util.tree_map(lambda l: P("pod"), tree)
    for off in walks:
        moved = jax.jit(lambda t: walk_permute_batch(t, specs, mesh, "pod", off))(tree)
        for li, x in enumerate(jax.tree_util.tree_leaves(moved)):
            out[f"walk_{off}_{li}"] = np.asarray(x)
    np.savez(sys.argv[1], **out)
""" % {"key": KEY_SEED})


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The reference's outputs: two subprocesses in parallel, the n = 4
    cases and the n = 8 cases with the walk hand-offs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    parts = [([c for c in CASES if c[0] == 4], []), ([c for c in CASES if c[0] == 8], [1, 3])]
    procs = []
    for i, part in enumerate(parts):
        path = str(tmp_path_factory.mktemp("gossip") / f"oracle{i}.npz")
        procs.append((path, subprocess.Popen(
            [sys.executable, "-c", _ORACLE, path, os.path.join(ROOT, "src"), repr(part)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    got = {}
    for path, proc in procs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        got.update(np.load(path))
    n_leaves = sum(1 for k in got if k.startswith("in"))
    return got, n_leaves, jax.tree_util.tree_structure(_j_base())


def _j_base():
    """The tree of the oracle: four leaves of a reduced Yi SMOKE model, 1-D
    (``final_norm``), 2-D (``embed``) and stacked over its layers."""
    from repro.models import transformer as JT

    cfg = dataclasses.replace(j_get_smoke("yi-6b"), d_model=64, d_ff=128, vocab=128)
    full = JT.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    slot = full["blocks"]["slot0"]
    return {"embed": full["embed"], "final_norm": full["final_norm"],
            "blocks": {"slot0": {"mixer": {"wq": slot["mixer"]["wq"]}, "norm1": slot["norm1"]}}}


def _torch_tree(treedef, leaves):
    """The port's nested dicts from the reference's treedef and leaves."""
    return jax.tree_util.tree_unflatten(treedef, [torch.from_numpy(np.array(x)) for x in leaves])


@jax.jit
def _fold(key, li, oi, me):
    for salt in (li, oi, me):
        key = jax.random.fold_in(key, salt)
    return key


def _ref_uniforms(key, shapes, block=(1,)):
    """The reference's uniforms of wire tensor (li, oi, pod): its key folded
    by li, oi and the pod, drawn at its local block shape."""
    def uniforms(li, oi, pod):
        k = _fold(key, li, oi, pod)
        return torch.from_numpy(np.asarray(
            jax.random.uniform(k, (*block, *shapes[li]), dtype=jnp.float32)))
    return uniforms


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_offsets_and_weights_match_reference(topology):
    for n in range(1, 10):
        jc, tc = jg.GossipConfig(topology=topology), tg.GossipConfig(topology=topology)
        assert tc.offsets(n) == jc.offsets(n)
        assert tg.mixing_weights(n, tc) == jg.mixing_weights(n, jc)
        assert abs(sum(w for _, w in tg.mixing_weights(n, tc)) - 1.0) < 1e-12
    assert tg.make_ring_weights(5) == jg.make_ring_weights(5)
    assert (tg.make_expander_weights(9, tg.GossipConfig())
            == jg.make_expander_weights(9, jg.GossipConfig()))
    with pytest.raises(ValueError, match="unknown gossip topology"):
        tg.GossipConfig(topology="torus").offsets(4)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(37,), (3, 130), (2, 4, 33)])
def test_wire_round_trip_matches_reference(bits, shape):
    rng = np.random.default_rng(sum(shape) + bits)
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 3.0, shape)).astype(np.float32)
    key = jax.random.PRNGKey(bits)
    q = jax.jit(lambda w, k: j_quantize(w, QuantConfig(bits=bits), k))(jnp.asarray(x), key)
    want = np.asarray(jax.jit(lambda q: j_dequantize(q))(q))
    u = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    spec = make_flat_spec(tx)
    rows = spec.rows

    def plane(a):
        return torch.nn.functional.pad(a.reshape(-1), (0, spec.d_pad - a.numel())).view(rows, 128)

    # Given the reference's (s, norm), B5 gives its codes bit for bit.
    s_ref = torch.full((rows,), float(q.s), dtype=torch.float32)
    n_ref = torch.full((rows,), float(q.norm), dtype=torch.float32)
    codes = qk.quantize_rows(plane(tx), plane(tu), s_ref, n_ref, bits=bits)
    np.testing.assert_array_equal(codes.reshape(-1)[: x.size].numpy().reshape(shape),
                                  np.asarray(q.indices))
    # The port's own side information, and the round trip through B5 and B6.
    (_, _), (s, norm) = tg._side_info(plane(tx).view(1, -1), spec, bits)
    for got, ref in ((s, q.s), (norm, q.norm)):
        ulps = abs(int(got.reshape(()).view(torch.int32))
                   - int(np.asarray(ref, np.float32).view(np.int32)))
        assert ulps <= NORM_ULPS
    got = tg._wire_round_trip(tx, bits, tu).numpy()
    cell = float(q.s) * float(q.norm)
    assert got.shape == shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= cell * (1 + 1e-5)


def _hold_mixed(got, want, cells, per_cell, label):
    """bits 32: within F32_TOL of the leaf's largest magnitude. bits < 32:
    each element within ``per_cell`` grid cells of the reference, and at
    most FLIP_SHARE of the elements beyond F32_TOL."""
    scale = float(np.abs(want).max())
    d = np.abs(got - want)
    assert np.isfinite(got).all(), label
    if cells is None:
        assert d.max() <= F32_TOL * scale, f"{label}: {d.max():.3e} of {scale:.3e}"
        return 0
    assert d.max() <= per_cell * cells + F32_TOL * scale, label
    flips = int((d > F32_TOL * scale).sum())
    assert flips <= FLIP_SHARE * d.size, f"{label}: {flips} of {d.size} elements moved"
    return flips


@pytest.mark.parametrize("n,topology,bits", CASES)
def test_gossip_mix_stacked_matches_reference(oracle, n, topology, bits):
    got_np, n_leaves, treedef = oracle
    inputs = [got_np[f"in{li}"][:n] for li in range(n_leaves)]
    tree = _torch_tree(treedef, inputs)
    cfg = tg.GossipConfig(topology=topology, quant_bits=bits)
    shapes = [x.shape[1:] for x in inputs]
    uniforms = None if bits == 32 else _ref_uniforms(jax.random.PRNGKey(KEY_SEED), shapes)
    mixed = tg.gossip_mix(tree, cfg, uniforms=uniforms)
    w = tg.mixing_weights(n, cfg)[1][1]
    n_offs = len(cfg.offsets(n))
    for li, leaf in enumerate(tree_leaves(mixed)):
        want = got_np[f"mix_{n}_{topology}_{bits}_{li}"]
        assert leaf.shape == want.shape and leaf.dtype == torch.float32
        levels = (1 << (bits - 1)) - 1
        cells = None if bits == 32 else float(np.abs(inputs[li]).max()) / levels
        _hold_mixed(leaf.numpy(), want, cells, n_offs * w * (1 + 1e-5),
                    f"n={n} {topology} bits={bits} leaf {li}")
    # Doubly stochastic: the mean over the pods is kept (bits 32).
    if bits == 32:
        for leaf, x in zip(tree_leaves(mixed), inputs):
            np.testing.assert_allclose(leaf.numpy().mean(0), x.mean(0), rtol=0,
                                       atol=1e-6 * float(np.abs(x).max()))


@pytest.mark.parametrize("offset", [1, 3])
def test_walk_permute_batch_matches_roll_and_reference(oracle, offset):
    got_np, n_leaves, treedef = oracle
    inputs = [got_np[f"in{li}"] for li in range(n_leaves)]
    moved = tg.walk_permute_batch(_torch_tree(treedef, inputs), PODS, offset)
    for li, leaf in enumerate(tree_leaves(moved)):
        np.testing.assert_array_equal(leaf.numpy(), np.roll(inputs[li], offset, axis=0))
        np.testing.assert_array_equal(leaf.numpy(), got_np[f"walk_{offset}_{li}"])
    with pytest.raises(ValueError, match="leading pod dimension"):
        tg.walk_permute_batch(_torch_tree(treedef, inputs), PODS + 1, offset)


def test_gossip_mix_contracts(oracle):
    """The wire needs a source of uniforms; the wire bits follow §IV-B; a
    single pod is left as it is; the generator path launches B5 and B6 once
    an offset on the payload of every leaf of every pod (CPU: the plain
    versions, counted nowhere)."""
    got_np, n_leaves, treedef = oracle
    inputs = [got_np[f"in{li}"][:4] for li in range(n_leaves)]
    tree = _torch_tree(treedef, inputs)
    with pytest.raises(ValueError, match="requires uniforms or a generator"):
        tg.gossip_mix(tree, tg.GossipConfig(quant_bits=8))
    qk.reset_launch_counts()
    mixed = tg.gossip_mix(tree, tg.GossipConfig(quant_bits=8),
                          generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(leaf).all() for leaf in tree_leaves(mixed))
    assert sum(qk.LAUNCHES.values()) == 0
    one = _torch_tree(treedef, [x[:1] for x in inputs])
    for leaf, x in zip(tree_leaves(tg.gossip_mix(one, tg.GossipConfig())), inputs):
        np.testing.assert_array_equal(leaf.numpy(), x[:1])
    spec = make_flat_spec(_torch_tree(treedef, [x[0] for x in inputs]))
    d = sum(spec.sizes)
    assert tg.gossip_wire_bits(spec, 4, tg.GossipConfig(quant_bits=8)) == \
        4 * 2 * (64 * n_leaves + 8 * d)
    assert tg.gossip_wire_bits(spec, 4, tg.GossipConfig()) == 4 * 2 * 32 * d
    with pytest.raises(TypeError, match="float32"):
        tg.gossip_mix(jax.tree_util.tree_map(lambda t: t.double(), tree), tg.GossipConfig())
