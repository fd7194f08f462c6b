"""The port's DFedRW pod deployment (``dist.make_fed_train_step``,
``launch.mesh.make_pod_mesh``, ``launch.train pod --fed``) and the
simulator's deployment export (``WindowSchedule``, ``SimTrace.schedule``,
``SimTrace.gossip_flags``) against the JAX package, on the CPU.

The reference's federated step runs in one subprocess per model with eight
forced host devices (``_ORACLE``), jitted on
``jax.sharding.Mesh(devices[:4].reshape(4, 1, 1), ("pod", "data",
"model"))``: four pods from the JAX SMOKE ``init_params`` copied to each
pod, zero velocities, three steps on batches drawn with a leading pod
dimension from ``np.random.default_rng(0)``, a key split each step. The
port's stacked step starts from the same weights (``convert.stack_pods``)
and batches; at bits < 32 it takes the reference's own uniforms (the step's
key folded by leaf, offset and pod), made in this process.

Contracts, with their tolerances:
- three steps of ``make_fed_train_step`` for the yi-6b and mamba2-130m
  SMOKE models, bits 32 and 8, gossip every 1 and 2 steps: the mean losses
  within 1e-4 (relative); every leaf of the parameters within ``STEP_TOL``
  of its largest magnitude at bits 32. At bits 8 a wire code rounds the
  other way where the pods' parameters, or the norms summed in another
  order, differ by an ulp: there each element is within ``STEP_TOL`` plus
  one grid cell times the mixing weight for each offset of each gossip,
  and at most ``FLIP_SHARE`` of all the elements lie beyond ``STEP_TOL``
  (a flip moves its element by a cell, and through the next local steps
  the gradients of the others, a small leaf's more than its own
  ``STEP_TOL``; uniforms paired with the wrong leaves or pods move a
  third of all the elements);
- ``scheduled=True`` fed the static pattern, and fed ``gossip_flags()`` of
  a recorded trace against the static period it encodes: bit for bit,
  with the CPU's deterministic kernels;
- ``schedule()`` and ``gossip_flags()`` of one trace file, loaded by each
  package: equal field by field;
- ``launch.train pod --fed --pods 4 --device cpu`` prints the losses and
  the spread of the step driven directly.
"""
import dataclasses
import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.dist.gossip import GossipConfig as JGossipConfig
from repro.dist.steps import make_gossip_step as j_make_gossip_step
from repro.models import transformer as JT
from repro.sim import SimTrace as JSimTrace

from repro_torch.configs import get_smoke
from repro_torch.convert import stack_pods
from repro_torch.core.flatten import tree_leaves
from repro_torch.dist import GossipConfig, make_fed_train_step, make_gossip_step, mixing_weights
from repro_torch.launch.mesh import make_pod_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import momentum_init
from repro_torch.sim import SimTrace, build_scenario
from _torch_threads import torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("yi-6b", "mamba2-130m")
PODS, BATCH, SEQ, STEPS, LR_R, KEY_SEED = 4, 2, 32, 3, 20.0, 7
CASES = [(arch, bits, every) for arch in ARCHS for bits in (32, 8) for every in (1, 2)]
LOSS_RTOL = 1e-4
STEP_TOL = 2e-4
FLIP_SHARE = 1e-3
CPU = torch.device("cpu")

_ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[3])
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_smoke
    from repro.dist.gossip import GossipConfig
    from repro.dist.sharding import batch_specs, named
    from repro.dist.steps import make_fed_train_step
    from repro.models import transformer as T

    arch, out = sys.argv[1], sys.argv[2]
    G, B, S, STEPS, LR_R, KEY = %(consts)s
    cfg = get_smoke(arch)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:G]).reshape(G, 1, 1),
                             ("pod", "data", "model"))
    base = T.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    res = {}
    for bits in (32, 8):
        for every in (1, 2):
            gossip = GossipConfig(axis="pod", topology="ring", every=every, quant_bits=bits)
            fn, p_specs, _ = make_fed_train_step(cfg, mesh, gossip, lr_r=LR_R, remat=False,
                                                 dtype=jnp.float32)
            params = jax.device_put(jax.tree_util.tree_map(
                lambda l: jnp.broadcast_to(l, (G, *l.shape)).copy(), base), named(p_specs, mesh))
            vel = jax.tree_util.tree_map(jnp.zeros_like, params)
            jitted = jax.jit(fn)
            rng = np.random.default_rng(0)
            key = jax.random.PRNGKey(KEY)
            losses = []
            with mesh:
                for s in range(STEPS):
                    toks = rng.integers(0, cfg.vocab, size=(G, B, S + 1))
                    batch = {"tokens": jnp.asarray(toks[..., :-1], jnp.int32),
                             "labels": jnp.asarray(toks[..., 1:], jnp.int32)}
                    batch = jax.device_put(batch, named(batch_specs(batch, mesh, fed_axis="pod"),
                                                        mesh))
                    key, sub = jax.random.split(key)
                    params, vel, loss = jitted(params, vel, batch, jnp.int32(s), sub)
                    losses.append(float(loss))
            res[f"{bits}_{every}_loss"] = np.array(losses)
            for li, leaf in enumerate(jax.tree_util.tree_leaves(params)):
                res[f"{bits}_{every}_p{li}"] = np.asarray(leaf)
    np.savez(out, **res)
""" % {"consts": repr((PODS, BATCH, SEQ, STEPS, LR_R, KEY_SEED))})


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The reference's losses and parameters, one subprocess a model, in
    parallel."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {}
    for arch in ARCHS:
        path = str(tmp_path_factory.mktemp("fed") / f"{arch}.npz")
        procs[arch] = (path, subprocess.Popen(
            [sys.executable, "-c", _ORACLE, arch, path, os.path.join(ROOT, "src")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    got = {}
    for arch, (path, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        got[arch] = dict(np.load(path))
    return got


@jax.jit
def _fold(key, li, oi, me):
    for salt in (li, oi, me):
        key = jax.random.fold_in(key, salt)
    return key


def _ref_uniforms(key, shapes):
    """The reference's uniforms of wire tensor (li, oi, pod) of one gossip:
    the step's key folded by li, oi and the pod, drawn at its local block
    shape (1, *leaf) on the (pods, 1, 1) mesh."""
    def uniforms(li, oi, pod):
        return torch.from_numpy(np.array(jax.random.uniform(
            _fold(key, li, oi, pod), (1, *shapes[li]), dtype=jnp.float32)))
    return uniforms


def _batches(cfg, steps=STEPS, pods=PODS):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab, size=(pods, BATCH, SEQ + 1))
        out.append({"tokens": torch.as_tensor(toks[..., :-1]),
                    "labels": torch.as_tensor(toks[..., 1:])})
    return out


def _j_base(arch):
    return jax.tree_util.tree_map(
        np.asarray, JT.init_params(j_get_smoke(arch), jax.random.PRNGKey(0), jnp.float32))


def flip_leaf(got, want, bits, per_cell):
    """One leaf under the contract at bits < 32: (max|d| within STEP_TOL of
    the leaf's largest magnitude plus ``per_cell`` grid cells, the elements
    beyond STEP_TOL)."""
    d = np.abs(got - want)
    scale = float(np.abs(want).max())
    cell = scale / ((1 << (bits - 1)) - 1)
    return bool(d.max() <= STEP_TOL * scale + per_cell * cell), int((d > STEP_TOL * scale).sum())


@pytest.mark.parametrize("arch,bits,every", CASES)
def test_fed_train_step_matches_reference(oracle, arch, bits, every):
    ref = oracle[arch]
    cfg = get_smoke(arch)
    gossip = GossipConfig(topology="ring", every=every, quant_bits=bits)
    step_fn, _, fed_abstract = make_fed_train_step(cfg, make_pod_mesh(PODS, device=CPU), gossip,
                                                lr_r=LR_R, remat=False)
    params = stack_pods(_j_base(arch), PODS, device="cpu")
    vel = momentum_init(params).velocity
    assert [tuple(a.shape) for a in tree_leaves(fed_abstract)] == \
        [tuple(p.shape) for p in tree_leaves(params)]
    shapes = [p.shape[1:] for p in tree_leaves(params)]
    key, losses, gossips = jax.random.PRNGKey(KEY_SEED), [], 0
    for step, batch in enumerate(_batches(cfg)):
        key, sub = jax.random.split(key)
        params, vel, loss = step_fn(params, vel, batch, step,
                                    uniforms=_ref_uniforms(sub, shapes) if bits < 32 else None)
        losses.append(float(loss))
        gossips += (step + 1) % every == 0
    np.testing.assert_allclose(losses, ref[f"{bits}_{every}_loss"], rtol=LOSS_RTOL, atol=0)
    w = mixing_weights(PODS, gossip)[1][1]
    per_cell = gossips * len(gossip.offsets(PODS)) * w * (1 + 1e-5)
    moved = total = 0
    for li, leaf in enumerate(tree_leaves(params)):
        got, want = leaf.numpy(), ref[f"{bits}_{every}_p{li}"]
        assert got.shape == want.shape and np.isfinite(got).all()
        scale = float(np.abs(want).max())
        d = np.abs(got - want)
        label = f"{arch} bits={bits} every={every} leaf {li}: max|d|={d.max():.3e} of {scale:.3e}"
        if bits == 32:
            assert d.max() <= STEP_TOL * scale, label
            continue
        within, beyond = flip_leaf(got, want, bits, per_cell)
        assert within, label
        moved += beyond
        total += d.size
    assert moved <= FLIP_SHARE * total, f"{moved} of {total} elements beyond {STEP_TOL}"


def _run_port(cfg, pods, steps, gossip, flags=None):
    step_fn, _, _ = make_fed_train_step(cfg, make_pod_mesh(pods, device=CPU), gossip, lr_r=LR_R,
                                        remat=False, scheduled=flags is not None)
    params = stack_pods(T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                        pods, device="cpu")
    vel = momentum_init(params).velocity
    gen = torch.Generator().manual_seed(1)
    losses = []
    for step, batch in enumerate(_batches(cfg, steps, pods)):
        extra = () if flags is None else (bool(flags[step]),)
        params, vel, loss = step_fn(params, vel, batch, step, *extra, generator=gen)
        losses.append(float(loss))
    return losses, params, vel


def _recorded_trace(path):
    """A trace recorded by the port's simulator: straggler_tail at n = 12,
    bits 8, three windows of k_walk steps."""
    setup = build_scenario("straggler_tail", n=12, seed=0, bits=8)
    res = setup.runner(device="cpu").run(3, torch.Generator().manual_seed(0), record=True)
    res.trace.save(path)
    return res.trace


@pytest.fixture
def deterministic():
    """The CPU's deterministic kernels: the gradient of the embedding
    lookup (``index_put_`` with accumulation) otherwise adds in the order
    the threads take, run to run."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def test_scheduled_step_matches_static(tmp_path, deterministic):
    """A host-bool gossip trigger gives the static period's step bit for
    bit: fed the static pattern, and fed ``gossip_flags()`` of a recorded
    trace (a gossip at each window's last step) against ``every = k_walk``."""
    cfg = get_smoke("mamba2-130m")
    trace = _recorded_trace(str(tmp_path / "trace.jsonl"))
    k = trace.header["k_walk"]
    flags = trace.gossip_flags()
    for every, pattern in ((2, [False, True, False, True]), (k, flags[: k + 1])):
        gossip = GossipConfig(topology="ring", every=every, quant_bits=8)
        static = _run_port(cfg, 3, len(pattern), gossip)
        sched = _run_port(cfg, 3, len(pattern), gossip, flags=pattern)
        assert static[0] == sched[0]
        for a, b in zip(tree_leaves(static[1:]), tree_leaves(sched[1:])):
            assert torch.equal(a, b)
    # Never gossiping leaves the pods apart; gossiping every step differs from it.
    apart = _run_port(cfg, 3, 2, GossipConfig(quant_bits=8), flags=[False, False])[1]
    mixed = _run_port(cfg, 3, 2, GossipConfig(quant_bits=8), flags=[True, True])[1]
    assert not torch.equal(tree_leaves(apart)[0], tree_leaves(mixed)[0])


def test_trace_schedule_matches_reference(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    _recorded_trace(path)
    ours, ref = SimTrace.load(path), JSimTrace.load(path)
    np.testing.assert_array_equal(ours.gossip_flags(), ref.gossip_flags())
    assert ours.gossip_flags().dtype == np.bool_ and ours.gossip_flags().sum() == 3
    mine, theirs = ours.schedule(), ref.schedule()
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        for field in dataclasses.fields(b):
            x, y = getattr(a, field.name), getattr(b, field.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, field.name
                np.testing.assert_array_equal(x, y, err_msg=field.name)
            else:
                assert x == y, field.name
        for prop in ("m_chains", "k_exec", "stalled", "dead_aggregators"):
            np.testing.assert_array_equal(getattr(a, prop), getattr(b, prop), err_msg=prop)
    assert [w.kbar0 for w in mine] == [0, 5, 10]


def test_pod_fed_launcher_matches_direct_step(capsys, deterministic):
    from repro_torch.launch.train import main

    argv = ["pod", "--arch", "mamba2-130m", "--smoke", "--fed", "--pods", "3", "--bits", "8",
            "--gossip-every", "2", "--steps", "3", "--batch", str(BATCH), "--seq", str(SEQ),
            "--lr_r", str(LR_R), "--device", "cpu"]
    main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "fed pod mode: 3 pods x data=1 (stacked on cpu) topology=ring every=2 bits=8"
    printed = [float(re.search(r"loss=(\S+)", ln).group(1)) for ln in lines[1:4]]
    assert [ln.split()[1] for ln in lines[1:4]] == ["0", "1", "2"]
    cfg = get_smoke("mamba2-130m")
    losses, params, _ = _run_port(cfg, 3, 3, GossipConfig(every=2, quant_bits=8))
    assert printed == [float(f"{x:.4f}") for x in losses]
    leaf = tree_leaves(params)[0]
    spread = float(torch.std(leaf, dim=0, correction=0).max())
    assert lines[4] == f"done (inter-pod param spread={spread:.5f})" and spread > 0


def _spec_leaves(specs):
    """The specs of a spec tree in sorted-key order (a spec is a tuple)."""
    if isinstance(specs, dict):
        return [spec for k in sorted(specs) for spec in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [spec for sub in specs for spec in _spec_leaves(sub)]
    return [specs]


def test_pod_mesh_and_gossip_step():
    """``make_pod_mesh`` without a group, and the gossip step's stacked
    shapes and placement against the reference's ``fed_abstract`` and
    ``p_specs``."""
    one = make_pod_mesh(device=CPU)
    assert (one.pods, one.device, one.group, one.data) == (1, CPU, None, 1)
    assert one.shape == {"pod": 1, "data": 1, "model": 1}
    assert make_pod_mesh(4, device=CPU).pods == 4
    with pytest.raises(ValueError, match="pods must be >= 0"):
        make_pod_mesh(-1, device=CPU)
    cfg, j_cfg = get_smoke("yi-6b"), j_get_smoke("yi-6b")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                             ("pod", "data", "model"))
    _, j_specs, j_abstract = j_make_gossip_step(j_cfg, mesh, JGossipConfig(), dtype=jnp.float32)
    gstep, p_specs, abstract = make_gossip_step(cfg, make_pod_mesh(device=CPU), GossipConfig())
    assert [(tuple(a.shape), a.device.type) for a in tree_leaves(abstract)] == \
        [(tuple(a.shape), "meta") for a in jax.tree_util.tree_leaves(j_abstract)]
    j_leaves = jax.tree_util.tree_leaves(
        j_specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert _spec_leaves(p_specs) == \
        [tuple(s) + (None,) * (a.ndim - len(s))
         for s, a in zip(j_leaves, jax.tree_util.tree_leaves(j_abstract))]
    params = stack_pods(T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), 1,
                        device="cpu")
    before = [p.clone() for p in tree_leaves(params)]
    assert gstep(params) is params                         # one pod: the identity, in place
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
