"""The port's tensor-parallel training (``dist.steps.make_train_step(cfg,
mesh)`` on a mesh whose model axis has two ranks, through the adjoints of
``dist.parallel``'s model-axis collectives) against the JAX package, on the
CPU: every model-axis case of ``_torch_tp_cases`` trained at (data 1,
model 2) on two ``torch.distributed`` processes, and ``yi``, ``grok-moe``
and ``seamless`` at (2, 2) on four, over gloo (``file://`` init with a
timeout, one thread each, deterministic algorithms).

The weights are the reference's ``init_params(PRNGKey(0), float32)``, saved
once; each rank takes its block with ``shard_lm_params(tree,
param_specs(abstract_params(cfg), mesh), mesh)`` and a zero velocity placed
by ``opt_specs`` (``shard_opt_state``). The global batches are the
data-axis tests' (``_torch_dp_cases.batches``, 4 x 12), each rank taking
its block by ``batch_specs``; STEPS steps with remat, as the reference
trains. The two-rank run's ranks also run the port's single-rank step on
the global batch, each for every other case. The JAX package runs its own
``make_train_step`` on a one-device ``jax.sharding.Mesh`` with automatic
axes, on the global batch, in this process while the ranks run.

Contracts, with their tolerances:
- every loss and the final parameters, gathered whole over both axes,
  against the reference: 1e-4 absolute and relative;
- against the port's single-rank step: max|d| within 1e-5 of the largest
  magnitude;
- every rank holds the same losses and gathered parameters, bit for bit,
  and each rank's blocks are ``shard_tree`` of the gathered tree;
- the adjoints on a two-rank toy against unsharded autograd (1e-5 of the
  largest magnitude): ``sum`` the identity, ``all_gather`` this rank's
  slice, ``enter`` the rank-order sum; the toy with ``enter``'s adjoint
  set to the identity misses the gradient of the tensor it entered;
- a rank that makes a collective its peers do not make fails at its
  group's timeout instead of hanging.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as j_configs
from repro.dist.steps import make_train_step as j_make_train_step
from repro.models import transformer as JT

from repro_torch.configs import get_smoke
from repro_torch.dist.sharding import param_specs, shard_tree
from repro_torch.models import transformer as T

from _torch_tp_train_cases import (CASES, LR_R, MESH4_CASES, SHAPE, STEPS, batches, flatten,
                                   smoke)
from _torch_threads import torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = dict(atol=1e-4, rtol=1e-4)
SELF_TOL = 1e-5
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
RUNS = [("1x2", name) for name in CASES] + [("2x2", name) for name in MESH4_CASES]
TOYS = ("sum", "all_gather", "enter", "ffn")

_WORKER = textwrap.dedent("""
    import datetime, os, sys
    rank, world, init, out, src, here, data = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                               sys.argv[4], sys.argv[5], sys.argv[6],
                                               int(sys.argv[7]))
    names = sys.argv[8].split(",")
    sys.path[:0] = [src, here]
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    from _torch_tp_train_cases import (CASES, LR_R, SHAPE, TOY_B, TOY_D, TOY_N, batches,
                                       flatten, smoke, unflatten, whole_over_model)
    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_params_from_numpy, shard_lm_params, shard_opt_state
    from repro_torch.dist.parallel import MeshAxis
    from repro_torch.dist.sharding import batch_specs, shard_tree
    from repro_torch.dist.steps import make_train_step, whole_params
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import momentum_init

    t = torch.from_numpy

    def arrays(tree, prefix):
        return {f"{prefix}/{k}": v.detach().numpy() for k, v in flatten(tree).items()}

    def train(cfg, tree, mesh):
        step_fn, p_specs = make_train_step(cfg, mesh, lr_r=LR_R)
        params = shard_lm_params(tree, p_specs, mesh, "cpu")
        zeros = unflatten({k: np.zeros_like(v) for k, v in flatten(tree).items()})
        vel = shard_opt_state(zeros, mesh, "cpu")
        calls = mesh.axis.stats["calls"]
        losses = []
        for step, batch in enumerate(batches(cfg, SHAPE)):
            batch = {k: t(v) for k, v in batch.items()}
            b_spec = batch_specs(batch, mesh)
            params, vel, loss = step_fn(params, vel, shard_tree(batch, b_spec, mesh), step,
                                        batch_spec=b_spec)
            losses.append(float(loss))
        res = {"losses": np.array(losses, np.float32),
               "collectives": mesh.axis.stats["calls"] - calls}
        res.update(arrays(params, "block"))
        whole = whole_over_model(whole_params(params, p_specs, mesh), p_specs, mesh.axis)
        res.update(arrays(whole, "params"))
        return res

    def single(cfg, tree):
        step_fn = make_train_step(cfg, lr_r=LR_R)
        params = lm_params_from_numpy(tree, "cpu")
        vel = momentum_init(params).velocity
        losses = []
        for step, batch in enumerate(batches(cfg, SHAPE)):
            params, vel, loss = step_fn(params, vel, {k: t(v) for k, v in batch.items()}, step)
            losses.append(float(loss))
        res = {"losses": np.array(losses, np.float32)}
        res.update(arrays(params, "params"))
        return res

    def grads(loss_of, ins):
        ins = [x.clone().requires_grad_() for x in ins]
        return [g.numpy() for g in torch.autograd.grad(loss_of(*ins), ins)]

    def toy(axis):
        # x (B, D) and c (B, D), cy (B, N) whole; W (D, N) split on its
        # columns, A (N, D) on its rows: each rank's share against the
        # unsharded autograd of the same function
        gen = torch.Generator().manual_seed(5)
        x, w, a, c = (torch.randn(*s, generator=gen) for s in (
            (TOY_B, TOY_D), (TOY_D, TOY_N), (TOY_N, TOY_D), (TOY_B, TOY_D)))
        cy = torch.randn(TOY_B, TOY_N, generator=gen)
        lo, hi = axis.span(TOY_N)
        h = torch.tanh(x @ w)
        res = {}
        # sum: the partial h_r @ A_r, summed, its adjoint the identity
        res["sum/want"] = grads(lambda a: ((h @ a) * c).sum(), [a])[0][lo:hi]
        res["sum/got"] = grads(lambda ar: (axis.sum(h[:, lo:hi] @ ar) * c).sum(), [a[lo:hi]])[0]
        # all_gather: the columns x @ W_r, gathered, its adjoint the slice
        res["all_gather/want"] = grads(lambda w: ((x @ w).square() * cy).sum(), [w])[0][:, lo:hi]
        res["all_gather/got"] = grads(
            lambda wr: (axis.all_gather(x @ wr, -1).square() * cy).sum(), [w[:, lo:hi]])[0]
        # enter: whole x into the rank's columns, its adjoint the rank-order sum
        res["enter/want"] = grads(lambda x: ((x @ w).square() * cy).sum(), [x])[0]
        res["enter/got"] = grads(
            lambda x: (axis.all_gather(axis.enter(x) @ w[:, lo:hi], -1).square() * cy).sum(),
            [x])[0]
        res["control/got"] = grads(
            lambda x: (axis.all_gather(x @ w[:, lo:hi], -1).square() * cy).sum(), [x])[0]
        # all three in a column-then-row layer, as the FFN
        want = grads(lambda x, w, a: ((torch.tanh(x @ w) @ a) * c).sum(), [x, w, a])
        got = grads(lambda x, wr, ar: (axis.sum(torch.tanh(axis.enter(x) @ wr) @ ar) * c).sum(),
                    [x, w[:, lo:hi], a[lo:hi]])
        res["ffn/want"] = np.concatenate([want[0].ravel(), want[1][:, lo:hi].ravel(),
                                          want[2][lo:hi].ravel()])
        res["ffn/got"] = np.concatenate([g.ravel() for g in got])
        return {f"toy/{k}": v for k, v in res.items()}

    def mismatch():
        # rank 0 makes a sum that rank 1 does not: it must fail at the
        # group's timeout, not hang
        group = dist.new_group(list(range(world)), timeout=datetime.timedelta(seconds=3))
        if rank != 0:
            return "skipped"
        try:
            MeshAxis(group, rank, world).sum(torch.ones(2))
        except RuntimeError as err:
            return f"RuntimeError: {str(err)[:200]}"
        return "no error"

    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_host_mesh(data, 2, device=torch.device("cpu"), group=dist.group.WORLD)
        for i, name in enumerate(names):
            cfg = smoke(get_smoke, *CASES[name])
            tree = unflatten(dict(np.load(os.path.join(out, f"{name}.params.npz"))))
            res = train(cfg, tree, mesh)
            if data == 1 and rank == i % world:
                res.update({f"single/{k}": v for k, v in single(cfg, tree).items()})
            np.savez(os.path.join(out, f"{data}x2.{name}.rank{rank}.npz"), **res)
        if data == 1:
            res = toy(mesh.axis)
            res["mismatch"] = np.array(mismatch())
            np.savez(os.path.join(out, f"toy.rank{rank}.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()
""")


def _spawn(world, out, data, names):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    init = out / f"init{data}"
    here = os.path.dirname(os.path.abspath(__file__))
    return [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), str(world), str(init),
                              str(out), os.path.join(ROOT, "src"), here, str(data),
                              ",".join(names)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(world)]


def _wait(procs, timeout):
    errors = []
    try:
        for rank, proc in enumerate(procs):
            _, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                errors.append(f"rank {rank}: {err[-3000:]}")
    finally:
        for proc in procs:
            proc.kill()
    assert not errors, "\n".join(errors)


def _jax_run(jcfg, tree):
    """The reference's make_train_step on a one-device mesh with automatic
    axes, STEPS steps on the global batches: the losses and the final
    params by path."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    step_fn = jax.jit(j_make_train_step(jcfg, mesh, lr_r=LR_R, remat=False)[0])
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jv = jax.tree_util.tree_map(jnp.zeros_like, jp)
    losses = []
    with mesh:
        for step, batch in enumerate(batches(jcfg, SHAPE)):
            jp, jv, loss = step_fn(jp, jv, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jnp.int32(step))
            losses.append(float(loss))
    return {"losses": np.array(losses),
            "params": flatten(jax.tree_util.tree_map(np.asarray, jp))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(mesh, case): (jax, [each rank's results])}, the single-rank runs by
    case, and each toy rank's results: the ranks run while the reference
    runs here."""
    out = tmp_path_factory.mktemp("tp_train")
    jcfgs, trees = {}, {}
    for name, (arch, over) in CASES.items():
        jcfgs[name] = smoke(j_configs.get_smoke, arch, over)
        trees[name] = jax.tree_util.tree_map(np.array, JT.init_params(
            jcfgs[name], jax.random.PRNGKey(0), jnp.float32))
        np.savez(out / f"{name}.params.npz", **flatten(trees[name]))
    two = _spawn(2, out, 1, list(CASES))
    four = _spawn(4, out, 2, list(MESH4_CASES))
    try:
        want = {name: _jax_run(jcfgs[name], trees[name]) for name in CASES}
    finally:
        _wait(four, 600)
        _wait(two, 900)
    got = {}
    for mesh, name in RUNS:
        world = 2 * MESHES[mesh][0]
        got[mesh, name] = (want[name], [dict(np.load(out / f"{mesh}.{name}.rank{r}.npz"))
                                        for r in range(world)])
    single = {name: _by(got["1x2", name][1][i % 2], "single/")
              for i, name in enumerate(CASES)}
    toys = [dict(np.load(out / f"toy.rank{r}.npz")) for r in range(2)]
    return got, single, toys


def _by(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _run_id(run):
    return f"{run[0]}-{run[1]}"


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_tensor_parallel_matches_jax(runs, run):
    """Every loss and the final parameters, gathered whole, within 1e-4 of
    the reference's step on the global batch."""
    want, ranks = runs[0][run]
    rank0 = ranks[0]
    assert rank0["losses"].shape == (STEPS,)
    np.testing.assert_allclose(rank0["losses"], want["losses"], err_msg="losses", **TOL)
    got = _by(rank0, "params/")
    assert sorted(got) == sorted(want["params"])
    for path, value in want["params"].items():
        np.testing.assert_allclose(got[path], value, err_msg=path, **TOL)


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_tensor_parallel_matches_single_rank(runs, run):
    """Losses and final parameters within 1e-5 of the largest magnitude of
    the port's single-rank step on the global batch."""
    _, ranks = runs[0][run]
    single = runs[1][run[1]]
    pairs = [("losses", ranks[0]["losses"], single["losses"])]
    pairs += [(path, value, single[f"params/{path}"])
              for path, value in _by(ranks[0], "params/").items()]
    for label, got, want in pairs:
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= SELF_TOL * scale, label


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_ranks_hold_equal_bits(runs, run):
    """Every rank holds the same losses and gathered parameters, bit for
    bit, and ran model-axis collectives."""
    _, ranks = runs[0][run]
    for res in ranks[1:]:
        for key, value in ranks[0].items():
            if key == "losses" or key.startswith("params/"):
                np.testing.assert_array_equal(value, res[key], err_msg=key)
    assert min(int(res["collectives"]) for res in ranks) > 0


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_blocks_are_shards_of_the_whole(runs, run):
    """Each rank stores only its blocks, ``shard_tree`` of the gathered
    tree by ``param_specs`` on the mesh; some leaf is cut."""
    _, ranks = runs[0][run]
    data, model = MESHES[run[0]]
    mesh = {"data": data, "model": model}
    cfg = smoke(get_smoke, *CASES[run[1]])
    flat_specs = flatten(param_specs(T.abstract_params(cfg), mesh))
    whole = _by(ranks[0], "params/")
    for r, res in enumerate(ranks):
        mine = _by(res, "block/")
        cut = shard_tree(whole, flat_specs, mesh, r)
        for path in whole:
            np.testing.assert_array_equal(mine[path], cut[path], err_msg=path)
        assert any(mine[p].size < whole[p].size for p in whole)


@pytest.mark.parametrize("op", TOYS)
def test_adjoint_on_a_two_rank_toy(runs, op):
    """On each rank the gradient through the op is the unsharded autograd's
    (this rank's slice of it for a split leaf), within 1e-5 of its largest
    magnitude; a whole tensor's gradient is the same bits on both ranks."""
    toys = runs[2]
    for res in toys:
        got, want = res[f"toy/{op}/got"], res[f"toy/{op}/want"]
        assert got.shape == want.shape
        scale = float(np.abs(want).max())
        assert scale > 0
        assert float(np.abs(got - want).max()) <= SELF_TOL * scale, op
    if op == "enter":
        np.testing.assert_array_equal(toys[0]["toy/enter/got"], toys[1]["toy/enter/got"])


def test_adjoint_control_without_enter(runs):
    """The toy's whole input taken into the rank's columns with the
    identity for an adjoint (no ``enter``): each rank's gradient holds only
    its columns' share and misses the unsharded one; the two shares add up
    to it."""
    toys = runs[2]
    want = toys[0]["toy/enter/want"]
    scale = float(np.abs(want).max())
    for res in toys:
        assert float(np.abs(res["toy/control/got"] - want).max()) > 1e-2 * scale
    both = toys[0]["toy/control/got"] + toys[1]["toy/control/got"]
    assert float(np.abs(both - want).max()) <= SELF_TOL * scale


def test_a_mismatched_collective_fails(runs):
    """A sum that one rank makes and its peer does not raises on that rank
    at its group's timeout."""
    toys = runs[2]
    assert str(toys[0]["mismatch"]).startswith("RuntimeError"), str(toys[0]["mismatch"])
    assert str(toys[1]["mismatch"]) == "skipped"
