"""The port's data axis (``launch.mesh.make_host_mesh`` with data > 1,
``dist.parallel.MeshAxis`` as the data axis, ``dist.steps.make_train_step(cfg,
mesh)``, ``moe_route``'s ``data_axis``, ``convert.shard_opt_state``) against
the JAX package, on the CPU: every LM family's SMOKE model trained
data-parallel at data = 2, its two ranks two ``torch.distributed`` processes
over gloo (``file://`` init, one thread each, deterministic algorithms).

The weights are the reference's ``init_params(PRNGKey(0), float32)``, saved
once; each rank takes its block with ``shard_lm_params(tree,
param_specs(abstract_params(cfg), mesh), mesh)`` and a zero velocity placed
by ``opt_specs`` (``shard_opt_state``) or by ``param_specs``. The global
batches (``_torch_dp_cases.batches``, 4 x 12 but for the batch of 1 and the
replicated 3 x 13) are made with numpy from a seed; each rank takes its
block by ``batch_specs``. Each rank runs STEPS steps of the data-parallel
step for every case, once a velocity placement; rank 0 also runs the
port's single-rank step on the global batch. The JAX package runs its own
``make_train_step`` on a one-device ``jax.sharding.Mesh`` with automatic
axes, on the global batch, in this process while the ranks run (the
reference's multi-device tests are red on this jax, ROADMAP.md C).

Contracts, with their tolerances:
- every loss and the final parameters against the reference: 1e-4
  absolute and relative;
- against the port's single-rank step: max|d| within 1e-5 of the largest
  magnitude;
- both ranks hold the same losses and gathered parameters, bit for bit,
  and each rank's blocks are ``shard_tree`` of the gathered tree;
- velocity placed by ``opt_specs`` gives the same bits as velocity placed
  by ``param_specs`` (the reference's
  ``test_opt_specs_state_multidevice_numerics_neutral`` claim);
- the MoE aux loss of a batch cut by rows is the global batch's (the
  reference's on the global batch within AUX_TOL), and the mean of the
  ranks' own aux losses misses it by more than AUX_TOL; the router's aux
  gradient averaged over the ranks is the global one (1e-5 of its largest
  magnitude), which the gradient of a gather that does not sum over the
  ranks (half of it at data = 2) misses;
- the (2, 1) and (1, 2) meshes over two ranks and the (2, 2) mesh over
  four put each rank at the coordinates ``sharding.mesh_coords`` gives and
  gather each axis over the ranks that share the other index; the
  tensor-parallel refusal names its ROADMAP.md item, and two pods over the
  four ranks make the reference's (2, 2, 1) pod mesh; the serve step on
  the (2, 2) mesh returns ``(fn, p_specs)``, its specs the placement ``fn``
  takes (the reference's, whole along the data axis), and ``fn`` on blocks
  placed by them gives a data rank's rows of the unsharded step's logits
  within atol = rtol = 1e-4.
"""
import json
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
from repro_torch.dist.sharding import mesh_coords, opt_specs, param_specs, shard_tree
from repro_torch.launch.mesh import group_backend
from repro_torch.models import transformer as T

from _torch_dp_cases import CASES, LR_R, MOE_ROWS, STEPS, batches, flatten, smoke
from _torch_threads import torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 2
TOL = dict(atol=1e-4, rtol=1e-4)
SELF_TOL = 1e-5
AUX_TOL = dict(atol=1e-7, rtol=1e-5)
MESH = {"data": WORLD, "model": 1}

_WORKER = textwrap.dedent("""
    import os, sys
    rank, world, init, out, src, here = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                         sys.argv[4], sys.argv[5], sys.argv[6])
    sys.path[:0] = [src, here]
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    from _torch_dp_cases import CASES, LR_R, MOE_ROWS, batches, flatten, smoke, unflatten
    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_params_from_numpy, shard_lm_params, shard_opt_state
    from repro_torch.dist.sharding import batch_specs, opt_specs, shard_tree
    from repro_torch.dist.steps import make_train_step, whole_params
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import momentum_init

    cpu = torch.device("cpu")
    t = torch.from_numpy

    def arrays(tree, prefix):
        return {f"{prefix}/{k}": v.detach().numpy() for k, v in flatten(tree).items()}

    def train(cfg, tree, shape, step_fn, specs, mesh, vel_specs):
        params = shard_lm_params(tree, specs, mesh, "cpu")
        zeros = unflatten({k: np.zeros_like(v) for k, v in flatten(tree).items()})
        vel = (shard_lm_params(zeros, specs, mesh, "cpu") if vel_specs is specs
               else shard_opt_state(zeros, mesh, "cpu"))
        calls = mesh.data_axis.stats["calls"]
        losses = []
        for step, batch in enumerate(batches(cfg, shape)):
            batch = {k: t(v) for k, v in batch.items()}
            b_spec = batch_specs(batch, mesh)
            params, vel, loss = step_fn(params, vel, shard_tree(batch, b_spec, mesh), step,
                                        batch_spec=b_spec)
            losses.append(float(loss))
        res = {"losses": np.array(losses, np.float32),
               "collectives": mesh.data_axis.stats["calls"] - calls}
        res.update(arrays(params, "block"))
        res.update(arrays(vel, "vblock"))
        res.update(arrays(whole_params(params, specs, mesh), "params"))
        res.update(arrays(whole_params(vel, vel_specs, mesh), "vel"))
        return res

    def single(cfg, tree, shape):
        step_fn = make_train_step(cfg, lr_r=LR_R)
        params = lm_params_from_numpy(tree, "cpu")
        vel = momentum_init(params).velocity
        losses = []
        for step, batch in enumerate(batches(cfg, shape)):
            params, vel, loss = step_fn(params, vel, {k: t(v) for k, v in batch.items()}, step)
            losses.append(float(loss))
        res = {"losses": np.array(losses, np.float32)}
        res.update(arrays(params, "params"))
        return res

    def aux_of(cfg, tree, batch, data_axis):
        # (aux, the routers' gradient of it) at the initial weights
        params = lm_params_from_numpy(tree, "cpu")
        names = [k for k in flatten(params) if k.endswith("router")]
        routers = [flatten(params)[k] for k in names]
        for r in routers:
            r.requires_grad_(True)
        _, aux = T.forward_train(cfg, params, batch["tokens"], batch.get("embeds"),
                                 remat=False, data_axis=data_axis)
        grads = torch.autograd.grad(aux, routers)
        return aux.detach(), dict(zip(names, grads))

    def meshes():
        res = {}
        for data, model in ((2, 1), (1, 2)):
            m = make_host_mesh(data, model, device=cpu, group=dist.group.WORLD)
            mine = torch.tensor([float(rank)])
            res[f"{data}x{model}"] = {
                "coords": [m.data_axis.rank, m.axis.rank],
                "sizes": [m.data_axis.size, m.axis.size],
                "data_gather": m.data_axis.all_gather(mine, 0).tolist(),
                "model_gather": m.axis.all_gather(mine, 0).tolist()}
        return res

    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(world, 1, device=cpu, group=dist.group.WORLD)
        for name, (arch, over, shape) in CASES.items():
            cfg = smoke(get_smoke, arch, over)
            tree = unflatten(dict(np.load(os.path.join(out, f"{name}.params.npz"))))
            step_fn, p_specs = make_train_step(cfg, mesh, lr_r=LR_R)
            o_specs = opt_specs(T.abstract_params(cfg), mesh)
            res = {}
            for by, specs in (("opt", o_specs), ("param", p_specs)):
                res.update({f"{by}/{k}": v for k, v in
                            train(cfg, tree, shape, step_fn, p_specs, mesh, specs).items()})
            if name in MOE_ROWS:
                batch = {k: t(v) for k, v in batches(cfg, shape)[0].items()}
                block = shard_tree(batch, batch_specs(batch, mesh), mesh)
                aux, grads = aux_of(cfg, tree, block, mesh.data_axis)
                res["aux"] = aux.numpy()
                for k, g in grads.items():
                    res[f"aux_grad/{k}"] = mesh.data_axis.mean(g).numpy()
                with torch.no_grad():
                    res["aux_own"] = T.forward_train(
                        cfg, lm_params_from_numpy(tree, "cpu"), block["tokens"],
                        block.get("embeds"), remat=False)[1].numpy()
                if rank == 0:
                    aux, grads = aux_of(cfg, tree, batch, None)
                    res["single/aux"] = aux.numpy()
                    res.update({f"single/aux_grad/{k}": g.numpy() for k, g in grads.items()})
            if rank == 0:
                res.update({f"single/{k}": v for k, v in single(cfg, tree, shape).items()})
            np.savez(os.path.join(out, f"{name}.rank{rank}.npz"), **res)
        import json
        json.dump(meshes(), open(os.path.join(out, f"meshes.rank{rank}.json"), "w"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
""")

# Four ranks: the (2, 2) mesh's coordinates and groups, and the refusals.
_MESH_WORKER = textwrap.dedent("""
    import json, os, sys
    rank, world, init, out, src = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                   sys.argv[4], sys.argv[5])
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke
    from repro_torch.dist.sharding import model_specs, param_specs, shard_tree, slot_rows
    from repro_torch.dist.steps import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.launch.mesh import make_host_mesh, make_pod_mesh
    from repro_torch.models import transformer as T

    def refusal(fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as err:
            return f"{type(err).__name__}: {err}"
        return "no error"

    def serve_pair():
        # the pair's specs are the placement fn takes: on this rank's rows of
        # four slots, fn on blocks placed by them gives the unsharded step's
        # logits
        fn, p_specs = make_serve_step(cfg, mesh)
        ref = param_specs(T.abstract_params(cfg), mesh)
        whole = T.init_params(cfg, torch.Generator().manual_seed(0), device=cpu)
        lo, hi = slot_rows(4, mesh, rank)
        token = torch.arange(3, 7)[:, None]
        pos = torch.arange(4, dtype=torch.int32)
        active = torch.ones(4, dtype=torch.bool)
        want, _ = make_serve_step(cfg)(whole, T.init_cache(cfg, 4, 8, device=cpu), token,
                                       pos, active)
        got, _ = fn(shard_tree(whole, p_specs, mesh),
                    T.init_cache(cfg, hi - lo, 8, device=cpu, axis=mesh.axis),
                    token[lo:hi], pos[lo:hi], active[lo:hi])
        return {"specs": [p_specs == model_specs(ref), p_specs != ref,
                          make_prefill_step(cfg, mesh)[1] == p_specs],
                "rows": [lo, hi], "got": got.tolist(), "want": want[lo:hi].tolist()}

    def pod_mesh():
        # two pods over the four ranks: the reference's (2, 2, 1) mesh
        pm = make_pod_mesh(2, device=cpu, group=group)
        return {"coords": [pm.pod, pm.host.data_axis.rank], "shape": pm.shape,
                "gossip_gather": pm.pod_axis.all_gather(mine, 0).tolist(),
                "data_gather": pm.host.data_axis.all_gather(mine, 0).tolist()}

    cpu = torch.device("cpu")
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    try:
        group = dist.group.WORLD
        mesh = make_host_mesh(2, 2, device=cpu, group=group)
        mine = torch.tensor([float(rank)])
        cfg = get_smoke("yi-6b")
        res = {"coords": [mesh.data_axis.rank, mesh.axis.rank],
               "sizes": [mesh.data_axis.size, mesh.axis.size], "shape": mesh.shape,
               "data_gather": mesh.data_axis.all_gather(mine, 0).tolist(),
               "model_gather": mesh.axis.all_gather(mine, 0).tolist(),
               "data_mean": mesh.data_axis.mean(mine).tolist(),
               "uneven": refusal(lambda: make_host_mesh(3, 1, device=cpu, group=group)),
               "train": refusal(lambda: make_train_step(cfg, mesh)),
               "serve": serve_pair(),
               "pods": pod_mesh(),
               "three_pods": refusal(lambda: make_pod_mesh(3, device=cpu, group=group))}
        json.dump(res, open(os.path.join(out, f"rank{rank}.json"), "w"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
""")


def _spawn(worker, world, out, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", worker, str(rank), str(world),
                              str(out / "init"), str(out), os.path.join(ROOT, "src"), *extra],
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


def _jax_run(jcfg, tree, shape, aux=False):
    """The reference's make_train_step on a one-device mesh with automatic
    axes, STEPS steps on the global batches: the losses and the final
    params by path, and with ``aux`` the aux loss of the first batch at the
    initial weights."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    step_fn, _ = j_make_train_step(jcfg, mesh, lr_r=LR_R, remat=False)
    step_fn = jax.jit(step_fn)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    if aux:
        first = batches(jcfg, shape)[0]
        aux = np.asarray(JT.forward_train(jcfg, jp, jnp.asarray(first["tokens"]),
                                          remat=False)[1])
    jv = jax.tree_util.tree_map(jnp.zeros_like, jp)
    losses = []
    with mesh:
        for step, batch in enumerate(batches(jcfg, shape)):
            jp, jv, loss = step_fn(jp, jv, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jnp.int32(step))
            losses.append(float(loss))
    return {"losses": np.array(losses), "params": flatten(jax.tree_util.tree_map(np.asarray, jp)),
            "aux": aux}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (jax, rank 0, rank 1)} and the meshes' {rank: facts} of the two
    spawns: the ranks run while the reference runs here."""
    out = tmp_path_factory.mktemp("dp")
    four = tmp_path_factory.mktemp("dp4")
    jcfgs, trees = {}, {}
    for name, (arch, over, _) in CASES.items():
        jcfgs[name] = smoke(j_configs.get_smoke, arch, over)
        trees[name] = jax.tree_util.tree_map(np.array, JT.init_params(
            jcfgs[name], jax.random.PRNGKey(0), jnp.float32))
        np.savez(out / f"{name}.params.npz", **flatten(trees[name]))
    here = os.path.dirname(os.path.abspath(__file__))
    procs = _spawn(_WORKER, WORLD, out, here)
    mesh_procs = _spawn(_MESH_WORKER, 4, four)
    try:
        want = {name: _jax_run(jcfgs[name], trees[name], CASES[name][2], name in MOE_ROWS)
                for name in CASES}
    finally:
        _wait(mesh_procs, 300)
        _wait(procs, 900)
    got = {name: (want[name], *(dict(np.load(out / f"{name}.rank{r}.npz")) for r in range(WORLD)))
           for name in CASES}
    meshes = {r: json.loads((out / f"meshes.rank{r}.json").read_text()) for r in range(WORLD)}
    meshes4 = {r: json.loads((four / f"rank{r}.json").read_text()) for r in range(4)}
    return got, meshes, meshes4


def _by(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


@pytest.mark.parametrize("name", list(CASES))
def test_data_parallel_matches_jax(runs, name):
    """Every loss and the final parameters within 1e-4 of the reference's
    step on the global batch."""
    want, rank0, _ = runs[0][name]
    assert rank0["opt/losses"].shape == (STEPS,)
    np.testing.assert_allclose(rank0["opt/losses"], want["losses"], err_msg="losses", **TOL)
    got = _by(rank0, "opt/params/")
    assert sorted(got) == sorted(want["params"])
    for path, value in want["params"].items():
        np.testing.assert_allclose(got[path], value, err_msg=path, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_data_parallel_matches_single_rank(runs, name):
    """Losses and final parameters within 1e-5 of the largest magnitude of
    the port's single-rank step on the global batch."""
    _, rank0, _ = runs[0][name]
    pairs = [("losses", rank0["opt/losses"], rank0["single/losses"])]
    single = _by(rank0, "single/params/")
    pairs += [(path, value, single[path]) for path, value in _by(rank0, "opt/params/").items()]
    for label, got, want in pairs:
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= SELF_TOL * scale, label


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_equal_bits(runs, name):
    """Both ranks hold the same losses and gathered parameters and velocity,
    bit for bit, and ran data collectives."""
    _, rank0, rank1 = runs[0][name]
    for key, value in rank0.items():
        if key.startswith(("opt/", "param/")) and key.split("/")[1] in ("losses", "params",
                                                                         "vel"):
            np.testing.assert_array_equal(value, rank1[key], err_msg=key)
    assert min(int(rank0["opt/collectives"]), int(rank1["opt/collectives"])) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_blocks_are_shards_of_the_whole(runs, name):
    """Each rank stores only its blocks: the parameters' are ``shard_tree``
    of the gathered tree by ``param_specs``, the velocity's by
    ``opt_specs``; some leaf is cut."""
    _, *ranks = runs[0][name]
    cfg = smoke(get_smoke, CASES[name][0], CASES[name][1])
    abstract = T.abstract_params(cfg)
    for kind, specs, block in (("params", param_specs(abstract, MESH), "block"),
                               ("vel", opt_specs(abstract, MESH), "vblock")):
        whole = _by(ranks[0], f"opt/{kind}/")
        flat_specs = flatten(specs)
        for r, res in enumerate(ranks):
            mine = _by(res, f"opt/{block}/")
            cut = shard_tree(whole, flat_specs, MESH, r)
            for path in whole:
                np.testing.assert_array_equal(mine[path], cut[path], err_msg=f"{kind} {path}")
            assert any(mine[p].size < whole[p].size for p in whole), kind


@pytest.mark.parametrize("name", list(CASES))
def test_opt_specs_velocity_is_numerics_neutral(runs, name):
    """Velocity placed by ``opt_specs`` and by ``param_specs`` gives the same
    losses, parameters and velocity, bit for bit; the two placements differ
    on some leaf."""
    _, *ranks = runs[0][name]
    for res in ranks:
        for key in ("losses", *(k[len("opt/"):] for k in res
                                if k.startswith(("opt/params/", "opt/vel/")))):
            np.testing.assert_array_equal(res[f"opt/{key}"], res[f"param/{key}"], err_msg=key)
    cfg = smoke(get_smoke, CASES[name][0], CASES[name][1])
    abstract = T.abstract_params(cfg)
    assert flatten(opt_specs(abstract, MESH)) != flatten(param_specs(abstract, MESH))


@pytest.mark.parametrize("name", MOE_ROWS)
def test_moe_aux_is_global(runs, name):
    """A batch cut by rows: every rank's aux loss is the global batch's
    (the reference's within AUX_TOL), which the mean of the ranks' own aux
    losses misses by more than AUX_TOL; the routers' aux gradient averaged
    over the ranks is the single rank's on the global batch, which half of
    it (a gather whose gradient does not sum over the ranks) misses."""
    want, rank0, rank1 = runs[0][name]
    for res in (rank0, rank1):
        np.testing.assert_allclose(res["aux"], want["aux"], **AUX_TOL)
    own = (float(rank0["aux_own"]) + float(rank1["aux_own"])) / 2
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(own, want["aux"], **AUX_TOL)
    single = _by(rank0, "single/aux_grad/")
    assert single
    for path, value in _by(rank0, "aux_grad/").items():
        scale = float(np.abs(single[path]).max())
        assert scale > 0
        assert float(np.abs(value - single[path]).max()) <= SELF_TOL * scale, path
        assert float(np.abs(value / WORLD - single[path]).max()) > SELF_TOL * scale, path


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_two_rank_meshes(runs, shape):
    """(2, 1) and (1, 2) over two ranks: rank r at data index r (model 0),
    or model index r; each axis gathers its ranks in rank order."""
    meshes = runs[1]
    data = shape == "2x1"
    for r in range(WORLD):
        got = meshes[r][shape]
        assert got["coords"] == ([r, 0] if data else [0, r])
        assert got["sizes"] == ([2, 1] if data else [1, 2])
        assert got["coords"] == [mesh_coords({"data": 2 if data else 1,
                                              "model": 1 if data else 2}, r)[ax]
                                 for ax in ("data", "model")]
        assert got["data_gather" if data else "model_gather"] == [0.0, 1.0]
        assert got["model_gather" if data else "data_gather"] == [float(r)]


def test_four_rank_mesh_and_refusals(runs):
    """(2, 2) over four ranks: rank r at (r // 2, r % 2), its model axis the
    ranks of its row and its data axis those of its column, each gathered
    in rank order; the data mean is the column's. A mesh that leaves a rank
    out raises ValueError; training on a model axis names A11b.4; two pods
    over the four ranks put rank r at pod r // 2 and data index r % 2, with
    its gossip group (its data index's ranks in pod order) and its pod's
    data group, and three pods raise ValueError; serving on it gives (fn,
    p_specs), whose specs
    place the weights fn runs on: this rank's two of four slots give the
    unsharded step's logits."""
    for r, got in runs[2].items():
        assert got["shape"] == {"data": 2, "model": 2} and got["sizes"] == [2, 2]
        assert got["coords"] == [r // 2, r % 2]
        assert got["model_gather"] == [float(r - r % 2), float(r - r % 2 + 1)]
        assert got["data_gather"] == [float(r % 2), float(r % 2 + 2)]
        assert got["data_mean"] == [r % 2 + 1.0]
        assert got["uneven"].startswith("ValueError") and "take them all" in got["uneven"]
        assert got["train"].startswith("NotImplementedError"), got["train"]
        assert "ROADMAP.md A11b.4" in got["train"], got["train"]
        pods = got["pods"]
        assert pods["coords"] == [r // 2, r % 2]
        assert pods["shape"] == {"pod": 2, "data": 2, "model": 1}
        assert pods["gossip_gather"] == [float(r % 2), float(r % 2 + 2)]
        assert pods["data_gather"] == [float(r - r % 2), float(r - r % 2 + 1)]
        assert got["three_pods"].startswith("ValueError") and "divide" in got["three_pods"]
        serve = got["serve"]
        assert serve["specs"] == [True, True, True]
        assert serve["rows"] == [2 * (r // 2), 2 * (r // 2) + 2]
        np.testing.assert_allclose(serve["got"], serve["want"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("local_world, cards, device_type, want", [
    (2, 1, "cuda", "gloo"),          # two ranks share the one card
    (4, 2, "cuda", "gloo"),
    (2, 2, "cuda", "nccl"),          # a card a rank
    (4, 8, "cuda", "nccl"),
    (1, 1, "cuda", "nccl"),
    (2, 0, "cpu", "gloo"),
    (1, 4, "cpu", "gloo"),
])
def test_group_backend(local_world, cards, device_type, want):
    """The launchers' backend: NCCL only when every local rank has a card of
    its own; gloo for ranks that share a card and on the CPU."""
    assert group_backend(local_world, cards, device_type) == want


_ONE_WRITE_A_LINE = textwrap.dedent("""
    import io, json, sys
    sys.path.insert(0, sys.argv[1])
    import torch, torch.distributed as dist
    from repro_torch.launch.mesh import join_torchrun

    class Writes(io.RawIOBase):
        def __init__(self):
            self.got = []
        def writable(self):
            return True
        def write(self, b):
            self.got.append(bytes(b).decode())
            return len(b)

    raw = Writes()
    sys.stdout = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)  # as python -u
    dev, backend = join_torchrun(torch.device("cpu"))
    print("step   0 loss=10.9817 (16.35s)", flush=True)
    print("done", flush=True)
    dist.destroy_process_group()
    sys.stderr.write(json.dumps([backend, raw.got]) + "\\n")
""")


def test_torchrun_ranks_write_a_line_at_once():
    """The ranks ``torchrun`` starts share one stdout: after
    ``join_torchrun`` every ``print`` leaves in one write, text and newline
    together, also where the stream wrote through (``python -u``), so no
    other rank's line can fall inside one of this rank's lines."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    proc = subprocess.run([sys.executable, "-u", "-c", _ONE_WRITE_A_LINE, os.path.join(ROOT, "src")],
                          env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    backend, writes = json.loads(proc.stderr.strip().splitlines()[-1])
    assert backend == "gloo"
    assert writes == ["step   0 loss=10.9817 (16.35s)\n", "done\n"]
