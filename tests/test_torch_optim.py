"""The port's optimizers (``repro_torch.optim``) against the JAX package's
``repro.optim.sgd``, on the CPU.

Each function gets the same numpy arrays on both sides, as trees of dicts
and lists. Contracts, with their tolerances:
- ``decreasing_lr``: the same float32 value, exactly;
- ``sgd_update``, ``momentum_sgd``, ``momentum_update`` (one and several
  steps, in place in the port): within 1 ulp-scale (atol 1e-7, rtol 1e-6;
  both take two float32 roundings an update, XLA may fuse one);
- ``adamw_init`` / ``adamw_update`` over several steps with and without
  weight decay: rtol 1e-5 (float32 powers ``b ** count`` and a square root
  computed by two libraries);
- the reference's quadratic laws of ``tests/test_optim.py``: SGD and
  momentum drive sum (p - 3)^2 below 1e-6 in 200 steps, AdamW drives
  sum (w - 1)^2 below 1e-4 in 300.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import sgd as J

from repro_torch import optim as O
from _torch_threads import torch_threads  # noqa: F401

STEP_TOL = dict(atol=1e-7, rtol=1e-6)
ADAM_TOL = dict(atol=1e-7, rtol=1e-5)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((3, 5))).astype(np.float32),
            "blocks": {"a": (scale * rng.standard_normal((2, 4, 6))).astype(np.float32),
                       "b": (scale * rng.standard_normal(7)).astype(np.float32)},
            "list": [(scale * rng.standard_normal(4)).astype(np.float32)]}


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree_close(got, want, tol):
    g_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), got, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g, np.asarray(w), **tol)


@pytest.mark.parametrize("kbar,r,q", [(1, 5.0, 0.499), (7, 100.0, 0.499), (1000, 2.0, 0.6)])
def test_decreasing_lr_is_the_reference_float32(kbar, r, q):
    assert O.decreasing_lr(kbar, r=r, q=q) == float(np.float32(J.decreasing_lr(kbar, r, q)))


def test_sgd_update_matches_jax():
    p, g = _tree(0), _tree(1)
    lr = O.decreasing_lr(3, r=5.0)
    want = J.sgd_update(_to_jax(p), _to_jax(g), jnp.float32(lr))
    _assert_tree_close(O.sgd_update(_to_torch(p), _to_torch(g), lr), want, STEP_TOL)


@pytest.mark.parametrize("beta", [0.9, 0.5])
def test_momentum_sgd_matches_jax_over_steps(beta):
    """Five heavy-ball steps with the decreasing schedule, the port in place."""
    jp, tp = _to_jax(_tree(0)), _to_torch(_tree(0))
    jv = jax.tree_util.tree_map(jnp.zeros_like, jp)
    tv = O.momentum_init(tp).velocity
    for step in range(5):
        g = _tree(10 + step)
        lr = O.decreasing_lr(step + 1, r=2.0)
        jp, jv = J.momentum_sgd(jp, jv, _to_jax(g), jnp.float32(lr), beta)
        same_p, same_v = tp, tv
        tp, tv = O.momentum_sgd(tp, tv, _to_torch(g), lr, beta)
        assert tp is same_p and tv is same_v             # updated in place
    _assert_tree_close(tp, jp, STEP_TOL)
    _assert_tree_close(tv, jv, STEP_TOL)


def test_momentum_update_matches_jax():
    p, g = _tree(2), _tree(3)
    jst = J.momentum_init(_to_jax(p))
    tst = O.momentum_init(_to_torch(p))
    assert isinstance(tst, O.MomentumState)
    jp, tp = _to_jax(p), _to_torch(p)
    for _ in range(3):
        jp, jst = J.momentum_update(jp, _to_jax(g), jst, jnp.float32(0.05))
        tp, tst = O.momentum_update(tp, _to_torch(g), tst, 0.05)
    _assert_tree_close(tp, jp, STEP_TOL)
    _assert_tree_close(tst.velocity, jst.velocity, STEP_TOL)


@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_matches_jax_over_steps(weight_decay):
    jp, tp = _to_jax(_tree(4)), _to_torch(_tree(4))
    jst, tst = J.adamw_init(jp), O.adamw_init(tp)
    assert int(tst["count"]) == 0
    for step in range(6):
        g = _tree(20 + step, scale=0.1)
        jp, jst = J.adamw_update(jp, _to_jax(g), jst, jnp.float32(0.01),
                                 weight_decay=weight_decay)
        tp, tst = O.adamw_update(tp, _to_torch(g), tst, 0.01, weight_decay=weight_decay)
    assert int(tst["count"]) == int(jst["count"]) == 6
    _assert_tree_close(tp, jp, ADAM_TOL)
    _assert_tree_close(tst["m"], jst["m"], ADAM_TOL)
    _assert_tree_close(tst["v"], jst["v"], ADAM_TOL)


def test_sgd_and_momentum_reduce_quadratic():
    """tests/test_optim.py's law, on the port."""
    def grad(p):
        q = p.detach().clone().requires_grad_()
        torch.sum((q - 3.0) ** 2).backward()
        return q.grad

    p = torch.zeros(4)
    for _ in range(200):
        p = O.sgd_update(p, grad(p), 0.1)
    assert float(torch.sum((p - 3.0) ** 2)) < 1e-6

    p = torch.zeros(4)
    st = O.momentum_init(p)
    for _ in range(200):
        p, st = O.momentum_update(p, grad(p), st, 0.02)
    assert float(torch.sum((p - 3.0) ** 2)) < 1e-6


def test_adamw_reduces_quadratic():
    p = {"w": torch.zeros(3)}
    st = O.adamw_init(p)
    for _ in range(300):
        w = p["w"].detach().clone().requires_grad_()
        torch.sum((w - 1.0) ** 2).backward()
        p, st = O.adamw_update(p, {"w": w.grad}, st, 0.05, weight_decay=0.0)
    assert float(torch.sum((p["w"] - 1.0) ** 2)) < 1e-4
