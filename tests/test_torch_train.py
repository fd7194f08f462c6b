"""Training in the port (the gradient of ``T.loss_fn``, ``remat``,
``dist.make_train_step`` and ``launch.train pod``) against the JAX package,
on the CPU.

Weights are the JAX ``T.init_params`` pytrees carried across with
``lm_params_from_numpy``; tokens, labels, stub embeddings and upstream
gradients are made with numpy from a seed. On the CPU the port's attention
and SSD take their plain versions, which autograd differentiates; on the
card the gradient comes from the backward kernels, held against autograd
through those plain versions by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``. The JAX side differentiates its plain ``jnp`` path (its
``attn_train`` materializes the softmax, its SSD is the chunked scan).

Contracts, with their tolerances:
- the plain versions' backward against ``jax.vjp`` of the JAX oracles
  (``block_attn/ref.py`` ``attention_ref``: causal, non-causal, cross with
  Lq != Lk, GQA; ``ssd_scan/ref.py`` ``ssd_chunked_jnp``, B/C per head as it
  takes them): each gradient within ``KERNEL_GRAD_TOL`` of the largest
  magnitude of that gradient (float32 on both sides, summed in other
  orders); dA_log within ``DA_LOG_TOL``: it sums over every position, and
  the JAX chunked scan keeps its log-decay prefix sums in float32 where
  the port's are float64 (ROADMAP.md C), which moves it by ~1e-4 of its
  largest magnitude at these shapes;
- the SMOKE ``loss_fn`` (``remat=False`` on the JAX side) and its gradient
  for ``mamba2-130m``, ``yi-6b``, ``seamless-m4t-large-v2``,
  ``jamba-1.5-large-398b`` and ``deepseek-v2-lite-16b``: the loss within
  1e-5 (relative), every leaf of the gradient within ``GRAD_TOL`` of its
  own largest magnitude;
- the backward kernels' algorithms, written out in torch as
  ``csrc/block_attn.cu`` and ``csrc/ssd_scan.cu`` compute them (P from
  the log-sum-exp, D = rowsum(dO o O); the SSD gradient's chunked matrix
  form, ddA from a strictly lower M = R o CB), in float64 against autograd
  through the plain versions: 1e-5 of each gradient's largest magnitude;
- ``remat=True`` against ``remat=False`` in the port: loss and gradient
  bit for bit (the recomputed forward is the same float32 arithmetic); a
  checkpoint a block and an encoder layer when a gradient is taken, none
  under ``no_grad``;
- three steps of ``dist.make_train_step`` against the reference's
  ``make_train_step`` jitted on a one-device host mesh: losses within 1e-5,
  the parameters and velocity after three steps within ``STEP_TOL`` of each
  leaf's largest magnitude;
- ``launch.train pod --device cpu --smoke`` prints a finite loss a step and
  ``done``; ``pod --fed`` prints a loss a step and the inter-pod spread
  (held against the reference in ``tests/test_torch_fed.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.kernels.block_attn.ref import attention_ref
from repro.kernels.ssd_scan.ref import ssd_chunked_jnp
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.dist import make_train_step
from repro_torch.kernels.block_attn import block_attention
from repro_torch.kernels.block_attn import block_attn as bk
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.kernels.ssd_scan import ssd_scan as sk
from repro_torch.models import transformer as T
from repro_torch.optim import momentum_init
from _torch_threads import torch_threads  # noqa: F401

ARCH_IDS = ["mamba2-130m", "yi-6b", "seamless-m4t-large-v2", "jamba-1.5-large-398b",
            "deepseek-v2-lite-16b"]
KERNEL_GRAD_TOL = 1e-4
DA_LOG_TOL = 1e-3
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
LOSS_TOL = dict(atol=0.0, rtol=1e-5)
SEQ = 64                     # a multiple of every SMOKE SSD chunk (32)


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _assert_normwise(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= tol * scale + 1e-9, f"{name}: max|d|={err:.3e} max|want|={scale:.3e}"


# ------------------------------------------------------------- kernel level
@pytest.mark.parametrize("b,lq,lk,h,kv,hd,causal", [
    (2, 40, 40, 4, 2, 16, True),          # causal GQA
    (1, 37, 37, 4, 4, 8, False),          # non-causal (an encoder)
    (2, 24, 50, 4, 1, 16, False),         # cross-attention, Lq != Lk, MQA
])
def test_attention_plain_backward_matches_jax(b, lq, lk, h, kv, hd, causal):
    q, k, v = (_normal((b, n, heads, hd), seed) for seed, (n, heads) in
               enumerate(((lq, h), (lk, kv), (lk, kv))))
    do = _normal((b, lq, h, hd), 7)
    rep = h // kv

    def jax_fn(q, k, v):       # (B, L, heads, hd) -> attention_ref's (BH, L, hd)
        kk, vv = (jnp.repeat(t, rep, axis=2) for t in (k, v))
        flat = lambda t: jnp.moveaxis(t, 2, 1).reshape(b * h, t.shape[1], hd)  # noqa: E731
        o = attention_ref(flat(q), flat(kk), flat(vv), causal=causal)
        return jnp.moveaxis(o.reshape(b, h, lq, hd), 1, 2)

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    bk.reset_launch_counts()
    out = block_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert bk.LAUNCHES["block_attn"] == 0 and sum(bk.BWD_LAUNCHES.values()) == 0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_normwise(g.numpy(), w, KERNEL_GRAD_TOL, name)


@pytest.mark.parametrize("b,h,l,p,n,g,chunk", [
    (2, 4, 64, 8, 16, 2, 16),
    (1, 3, 96, 16, 8, 1, 32),
    (2, 2, 40, 4, 6, 2, 8),
])
def test_ssd_plain_backward_matches_jax(b, h, l, p, n, g, chunk):
    rng = np.random.default_rng(3)
    x = _normal((b, h, l, p), 1)
    dt = np.logaddexp(rng.standard_normal((b, h, l)), 0.0).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    bb, cc = _normal((b, g, l, n), 2, 0.5), _normal((b, g, l, n), 3, 0.5)
    dy = _normal((b, h, l, p), 4)
    rep = h // g

    def jax_fn(x, dt, a_log, bb, cc):
        return ssd_chunked_jnp(x, dt, a_log, jnp.repeat(bb, rep, axis=1),
                               jnp.repeat(cc, rep, axis=1), chunk)

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(t) for t in (x, dt, a_log, bb, cc)))
    want = vjp(jnp.asarray(dy))
    ins = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a_log, bb, cc)]
    sk.reset_launch_counts()
    got = torch.autograd.grad(ssd_chunked(*ins, chunk=chunk), ins, torch.from_numpy(dy))
    assert sk.LAUNCHES["ssd_scan"] == 0 and sum(sk.BWD_LAUNCHES.values()) == 0
    for name, gt, w in zip(("dx", "ddt", "da_log", "db", "dc"), got, want):
        _assert_normwise(gt.numpy(), w, DA_LOG_TOL if name == "da_log" else KERNEL_GRAD_TOL,
                         name)


# ------------------------------------- the backward kernels' algorithms
def _attn_backward_as_the_kernels(q, k, v, o, lse, do, causal, window):
    """csrc/block_attn.cu's backward in torch: P from the forward's
    log-sum-exp (0 where masked or where the row attends no key), D =
    rowsum(dO o O), dS = P (dP - D); dK/dV summed over each KV group."""
    b, lq, h, hd = q.shape
    lk, kv = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(hd)
    i, j = torch.arange(lq)[:, None], torch.arange(lk)[None, :]
    ok = torch.ones(lq, lk, dtype=torch.bool)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= (i - j) < window
    kh, vh = (t.repeat_interleave(h // kv, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kh) * scale
    l_ = lse[..., None]
    live = ok & torch.isfinite(l_)
    p = torch.where(live, torch.exp(s - torch.where(torch.isfinite(l_), l_, 0.0)), 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vh)
              - (do * o).sum(-1).transpose(1, 2)[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do).reshape(b, lk, kv, h // kv, hd).sum(3)
    dk = (torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale).reshape(b, lk, kv, h // kv, hd).sum(3)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kh) * scale, dk, dv


@pytest.mark.parametrize("lq,lk,causal,window", [
    (40, 40, True, 0), (24, 50, False, 0), (33, 33, True, 5), (30, 12, True, 0),
    (20, 14, False, 4),                   # rows 17+ attend no key
])
def test_attention_backward_algorithm_matches_autograd(lq, lk, causal, window):
    """The kernels' formulas (float64) against autograd through the plain
    version, rows that attend no key included (zero gradient, no NaN)."""
    from repro_torch.kernels.block_attn.ref import attention_lse_plain, block_attention_plain

    q, k, v = (torch.from_numpy(_normal(shape, seed)).double() for seed, shape in
               enumerate(((2, lq, 4, 8), (2, lk, 2, 8), (2, lk, 2, 8))))
    do = torch.from_numpy(_normal((2, lq, 4, 8), 9)).double()
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o = block_attention_plain(*ins, causal=causal, window=window)
    want = torch.autograd.grad(o, ins, do)
    lse = attention_lse_plain(q, k, causal=causal, window=window).double()
    got = _attn_backward_as_the_kernels(q, k, v, o.detach().double(), lse, do, causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_normwise(g.numpy(), w.double().numpy(), 1e-5, name)


def _ssd_backward_as_the_kernels(x, dt, a_log, b, c, dy, chunk, mm=torch.matmul):
    """csrc/ssd_scan.cu's backward in torch, in its chunked matrix form
    (positions i, j of a chunk; L_ij = exp(cum_i - cum_j), j <= i; w_j =
    exp(cum_last - cum_j); S_c the state entering chunk c; G_c = dloss/dS_{c+1}),
    kernel by kernel: C B^T (bwd_chunk_cb); dS^loc_c = (C o exp(cum))^T dy
    and G carried back over the chunks (bwd_chunk_state, bwd_state_pass);
    with R = (dy xdt^T) o L, dC = R B + diag(exp cum) dy S_c^T and the rows'
    dcum terms (bwd_chunk_dc); dB = R^T C + diag(w) xdt G_c^T, dxdt = (CB o
    L)^T dy + (B o w) G_c and the columns' terms from R^T (bwd_chunk_db);
    ddA the reverse cumulative sum of dcum_s = sum_{j<s} M_sj - sum_{i>s}
    M_is + y^off_s.dy_s (M = R o CB strictly lower), plus exp(cum_last)
    <G_c, S_c> + sum_{j<r} w_j B_j^T G_c xdt_j, then ddt and dA_log, in
    float64 (bwd_ddt). B/C (B, G, L, N); dB/dC summed over each group. A
    ragged last chunk is padded with dt = 0.

    Every product goes through ``mm`` (tests/test_torch_ssd.py passes its
    3xTF32 emulation). cum is float64 in units of log2; each difference is
    rounded to the inputs' dtype once and raised with exp2, masked before
    the exp, as the kernels do."""
    bsz, h, l, p = x.shape
    g, n = b.shape[1], b.shape[3]
    pad = (-l) % chunk
    x, b, c, dy = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (x, b, c, dy))
    dt = torch.nn.functional.pad(dt, (0, pad))
    nc = (l + pad) // chunk
    a = -torch.exp(a_log)
    dtc = dt.reshape(bsz, h, nc, chunk)
    cum = torch.cumsum((dtc * a[:, None, None]).double(), -1) * np.log2(np.e)
    group = torch.arange(h) // (h // g)
    bc, cc = (t.reshape(bsz, g, nc, chunk, n)[:, group] for t in (b, c))
    xc, dyc = (t.reshape(bsz, h, nc, chunk, p) for t in (x, dy))
    xdt = xc * dtc[..., None]
    last = cum[..., -1:]
    w = torch.exp2((last - cum).to(x.dtype))
    decay = torch.exp2(last[..., 0].to(x.dtype))
    ecum = torch.exp2(cum.to(x.dtype))
    lower = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    diff = (cum[..., :, None] - cum[..., None, :]).to(x.dtype)
    el = torch.exp2(diff.masked_fill(~lower, float("-inf")))
    # The forward's entering states S_c, as its kernels leave them.
    ds = mm((bc * (dtc * w)[..., None]).transpose(-1, -2), xc)
    s, entering = torch.zeros_like(ds[:, :, 0]), []
    for z in range(nc):
        entering.append(s)
        s = decay[:, :, z, None, None] * s + ds[:, :, z]
    st = torch.stack(entering, 2)
    # 1-2. dS^loc per chunk, then G carried back: G_{nc-1} = 0.
    loc = mm((cc * ecum[..., None]).transpose(-1, -2), dyc)
    carry, gs = torch.zeros_like(loc[:, :, 0]), [None] * nc
    for z in range(nc - 1, -1, -1):
        gs[z] = carry
        carry = decay[:, :, z, None, None] * carry + loc[:, :, z]
    gc = torch.stack(gs, 2)
    cb = mm(cc, bc.transpose(-1, -2))
    # 3. The chunk-tile products: bwd_chunk_dc, then bwd_chunk_db.
    dc_off = ecum[..., None] * mm(dyc, st.transpose(-1, -2))
    r = mm(dyc, xdt.transpose(-1, -2)) * el
    dc = dc_off + mm(r, bc)
    rows = (r * cb).tril(-1).sum(-1) + (cc * dc_off).sum(-1)
    bg = mm(bc, gc)
    u = (xc * bg).sum(-1) * dtc * w
    rt = mm(xdt, dyc.transpose(-1, -2)) * el.transpose(-1, -2)
    db = w[..., None] * mm(xdt, gc.transpose(-1, -2)) + mm(rt, cc)
    dxdt = w[..., None] * bg + mm((cb * el).transpose(-1, -2), dyc)
    cols = (rt * cb.transpose(-1, -2)).triu(1).sum(-1)
    xdx = (dxdt * xc).sum(-1)
    # 4. bwd_ddt: ddA, ddt, dA_log in float64.
    dcum = rows.double() - cols.double()
    u64 = u.double()
    state = decay.double() * (gc.double() * st.double()).sum((-1, -2))
    dda = dcum.flip(-1).cumsum(-1).flip(-1) + state[..., None] + u64.cumsum(-1) - u64
    ddt = (xdx.double() + a.double()[:, None, None] * dda).to(x.dtype)
    da = (a.double() * (dda * dtc.double()).sum((0, 2, 3))).to(x.dtype)

    def cut(t):
        return t.reshape(bsz, h, nc * chunk, *t.shape[4:])[:, :, :l]

    db, dc = (cut(t).reshape(bsz, g, h // g, l, n).sum(2) for t in (db, dc))
    return cut(dxdt * dtc[..., None]), cut(ddt), da, db, dc


@pytest.mark.parametrize("b,h,l,p,n,g,chunk", [
    (2, 4, 37, 8, 6, 2, 8),               # a ragged last chunk, G < H
    (1, 3, 64, 5, 4, 1, 16),
    (1, 2, 96, 16, 16, 2, 32),            # G = H
])
def test_ssd_backward_algorithm_matches_autograd(b, h, l, p, n, g, chunk):
    """The kernels' chunked stages and the dcum identity (float64) against
    autograd through ``ssd_chunked_plain`` (float32): the algorithm, not its
    float32 rounding (tests/test_torch_ssd.py emulates that; the card holds
    the kernels, tests/test_torch_gpu.py)."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain

    rng = np.random.default_rng(4)
    x = torch.from_numpy(_normal((b, h, l, p), 1)).double()
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((b, h, l)), 0.0))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float64))
    bb, cc = (torch.from_numpy(_normal((b, g, l, n), seed, 0.5)).double() for seed in (2, 3))
    dy = torch.from_numpy(_normal((b, h, l, p), 5)).double()
    # The plain version is float32 (its prefix sums float64) by design.
    ins = [t.float().requires_grad_() for t in (x, dt, a_log, bb, cc)]
    want = torch.autograd.grad(ssd_chunked_plain(*ins, chunk)[0], ins, dy.float())
    got = _ssd_backward_as_the_kernels(x, dt, a_log, bb, cc, dy, chunk)
    for name, gt, w in zip(("dx", "ddt", "da_log", "db", "dc"), got, want):
        _assert_normwise(gt.numpy(), w.double().numpy(), 1e-5, name)


def test_remat_checkpoints_only_when_a_gradient_is_taken(monkeypatch):
    """``remat`` wraps each block (with its cross layer) and each encoder
    layer in a checkpoint when a gradient is taken, and nothing under
    ``no_grad``: decode and the forward phases keep their launch counts."""
    _, cfg, tree = _params("seamless-m4t-large-v2")
    params = lm_params_from_numpy(tree, device="cpu")
    batch = _torch_batch(_batch(cfg, seed=2))
    calls = []
    real = T.checkpoint
    monkeypatch.setattr(T, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        T.loss_fn(cfg, params, batch, remat=True)
    assert calls == []
    _port_grad(cfg, params, batch, remat=True)
    assert len(calls) == cfg.n_blocks + cfg.n_enc_layers


# -------------------------------------------------------------- model level
_PARAMS = {}


def _params(arch_id):
    """(JAX config, port config, JAX params as numpy) of a SMOKE model."""
    if arch_id not in _PARAMS:
        jcfg = j_configs.get_smoke(arch_id)
        jp = JT.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
        _PARAMS[arch_id] = (jcfg, configs.get_smoke(arch_id),
                            jax.tree_util.tree_map(np.array, jp))
    return _PARAMS[arch_id]


def _batch(cfg, seed=0, batch=2, seq=SEQ):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq + 1))
    out = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    if cfg.frontend != "none":
        out["embeds"] = _normal((batch, cfg.frontend_tokens, cfg.d_model), seed + 100)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grad(cfg, params, batch, remat):
    leaves = jax.tree_util.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = T.loss_fn(cfg, params, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), grads


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_loss_and_grad_match_jax(arch_id):
    jcfg, cfg, tree = _params(arch_id)
    batch = _batch(cfg)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, _jax_batch(batch), remat=False))(
            jax.tree_util.tree_map(jnp.asarray, tree))
    params = lm_params_from_numpy(tree, device="cpu")
    loss, grads = _port_grad(cfg, params, _torch_batch(batch), remat=True)
    np.testing.assert_allclose(float(loss), float(j_loss), **LOSS_TOL)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(j_grads)[0]]
    for path, g, w in zip(paths, grads, jax.tree_util.tree_leaves(j_grads)):
        _assert_normwise(g.numpy(), w, GRAD_TOL, f"{arch_id} {path}")


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_remat_is_bit_identical(arch_id):
    _, cfg, tree = _params(arch_id)
    batch = _torch_batch(_batch(cfg, seed=1))
    params = lm_params_from_numpy(tree, device="cpu")
    loss_r, grads_r = _port_grad(cfg, params, batch, remat=True)
    loss, grads = _port_grad(cfg, params, batch, remat=False)
    assert torch.equal(loss_r, loss)
    for a, b in zip(grads_r, grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_three_train_steps_match_jax(arch_id):
    from repro.dist.steps import make_train_step as j_make_train_step

    jcfg, cfg, tree = _params(arch_id)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    j_step, _ = j_make_train_step(jcfg, mesh, lr_r=20.0, remat=False)
    j_step = jax.jit(j_step)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jv = jax.tree_util.tree_map(jnp.zeros_like, jp)
    step_fn = make_train_step(cfg, lr_r=20.0)
    tp = lm_params_from_numpy(tree, device="cpu")
    tv = momentum_init(tp).velocity
    for step in range(3):
        batch = _batch(cfg, seed=10 + step)
        with mesh:
            jp, jv, j_loss = j_step(jp, jv, _jax_batch(batch), jnp.int32(step))
        tp, tv, loss = step_fn(tp, tv, _torch_batch(batch), step)
        np.testing.assert_allclose(float(loss), float(j_loss), **LOSS_TOL)
    for name, got, want in (("params", tp, jp), ("velocity", tv, jv)):
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            _assert_normwise(g.numpy(), w, STEP_TOL, f"{arch_id} {name}")


def test_pod_launcher_on_the_cpu(capsys):
    from repro_torch.launch.train import main

    main(["pod", "--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--steps", "2",
          "--batch", "2", "--seq", "32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "done" and len(lines) == 3
    for i, line in enumerate(lines[:2]):
        assert line.startswith(f"step {i:3d} loss=")
        assert np.isfinite(float(line.split("loss=")[1].split()[0]))
    main(["pod", "--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--fed", "--pods", "2",
          "--steps", "1", "--batch", "1", "--seq", "32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("fed pod mode: 2 pods") and lines[1].startswith("step   0 loss=")
    assert lines[-1].startswith("done (inter-pod param spread=")
