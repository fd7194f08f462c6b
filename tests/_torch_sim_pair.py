"""Shared harness of the simulator parity tests (tests/test_torch_sim*.py):
one scenario built by the JAX package (``repro.sim``) and by the port
(``repro_torch.sim``), run side by side on the CPU from the same initial
params and, at bits < 32, the JAX run's own quantizer seed words.

The contract (with tests/test_torch_dfedrw.py's bounds): every
``SimRoundRecord`` field except the host wall times, the window plans, batch
indices, aggregation plans, Eq. 18 bits and the numpy rng states are
exactly equal; the device matrix is within rtol 1e-5 /
atol 1e-6 at bits 32 and within 0.05 * scale + 1e-4 at bits < 32.
"""
import numpy as np
import torch

import jax

import repro.sim as jsim
import repro_torch.sim as tsim
from repro_torch.convert import params_from_numpy

RECORD_FIELDS = ("round", "t_start", "t_compute_end", "t_end", "events",
                 "k_planned", "k_done", "k_exec", "killed", "agg_latency_s",
                 "resumed", "bits")
WINDOW_FIELDS = ("round", "t_start", "t_compute_end", "t_end", "agg_latency_s",
                 "events", "k_planned", "k_done", "killed", "resumed", "devices",
                 "exec_mask", "account_mask", "timestamps", "bidx", "agg_devices",
                 "agg_rows", "agg_weights", "bits")


def jax_qseeds(key, k):
    """The uint32 seed words the JAX flat engine derives from a round key for
    its K hop payloads and its one aggregation payload."""
    words = []
    for _ in range(k + 1):
        key, sub = jax.random.split(key)
        words.append(np.asarray(jax.random.key_data(sub)).reshape(-1)[:2])
    return np.stack(words)


def window_qseeds(root, windows, k):
    """Per-window seed words, split from ``root`` as the JAX ``_drive`` does."""
    out, key = [], root
    for _ in range(windows):
        key, sub = jax.random.split(key)
        out.append(jax_qseeds(sub, k))
    return out


def rng_states(runner):
    """Every numpy generator the timeline and the planner draw from: the
    protocol rng, the link model's jitter rng and each device's churn rng."""
    out = {"protocol": runner.engine.rng.bit_generator.state}
    link_rng = getattr(runner.link, "_rng", None)
    if link_rng is not None:
        out["link"] = link_rng.bit_generator.state
    out["churn"] = {d: g.bit_generator.state
                    for d, g in sorted(runner.fleet._churn_rngs.items())}
    return out


def build_pair(scenario, n=12, seed=0, **overrides):
    return (jsim.build_scenario(scenario, n=n, seed=seed, **overrides),
            tsim.build_scenario(scenario, n=n, seed=seed, **overrides))


def run_pair(scenario, windows, n=12, seed=0, engine=None, jengine=None,
             obs=None, **overrides):
    """Run both packages' simulators ``windows`` windows, recording traces
    and, after every window, both runners' rng states. ``obs`` is a pair of
    recorders (JAX, port) to attach. Returns a dict of the pieces."""
    jsetup, tsetup = build_pair(scenario, n=n, seed=seed, **overrides)
    np.testing.assert_array_equal(jsetup.data.client_idx, tsetup.data.client_idx)
    jr = jsetup.runner(engine=jengine or engine)
    tr = tsetup.runner(engine=engine, device="cpu")
    if obs is not None:
        jr.attach_obs(obs[0])
        tr.attach_obs(obs[1])
    root = jax.random.PRNGKey(1)
    params = jsetup.model.init(root)
    tparams = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in params],
                                device="cpu")
    qseeds = window_qseeds(root, windows, jsetup.cfg.k_walk)
    snaps = ([], [])

    def cb(which, runner):
        return lambda r, m, e, rec: snaps[which].append(rng_states(runner))

    jres = jr.run(windows, root, jsetup.x_test, jsetup.y_test, eval_every=1,
                  callback=cb(0, jr), record=True)
    tres = tr.run(windows, torch.Generator().manual_seed(0), tsetup.x_test,
                  tsetup.y_test, eval_every=1, callback=cb(1, tr), record=True,
                  qseeds=qseeds, params=tparams)
    return dict(jsetup=jsetup, tsetup=tsetup, jr=jr, tr=tr, jres=jres, tres=tres,
                jsnaps=snaps[0], tsnaps=snaps[1], qseeds=qseeds, tparams=tparams,
                root=root)


def assert_same_value(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (what, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what
    else:
        assert a == b, (what, a, b)


def assert_same_timeline(jres, tres, jsnaps=None, tsnaps=None):
    """Records, recorded window plans, Eq. 18 bits and rng states equal."""
    assert len(jres.records) == len(tres.records)
    for i, (ra, rb) in enumerate(zip(jres.records, tres.records)):
        for f in RECORD_FIELDS:
            assert_same_value(getattr(ra, f), getattr(rb, f), (i, f))
    assert jres.virtual_time_s == tres.virtual_time_s
    assert jres.events_total == tres.events_total
    if jres.trace is not None:
        assert tres.trace is not None
        for k in ("n", "m_chains", "k_walk", "batch_size", "bits", "policy",
                  "deadline_s", "version", "schema"):
            assert jres.trace.header[k] == tres.trace.header[k], k
        for i, (wa, wb) in enumerate(zip(jres.trace.windows, tres.trace.windows)):
            for f in WINDOW_FIELDS:
                assert_same_value(getattr(wa, f), getattr(wb, f), (i, f))
    hj, ht = jres.history, tres.history
    assert hj.rounds == ht.rounds
    assert hj.comm_bits == ht.comm_bits
    assert hj.comm_bits_busiest == ht.comm_bits_busiest
    if jsnaps is not None:
        assert len(jsnaps) == len(tsnaps) == len(jres.records)
        for i, (a, b) in enumerate(zip(jsnaps, tsnaps)):
            assert a == b, i


def assert_params_close(jres, tres, quantized):
    jmat = np.asarray(jres.state.device_params)
    tmat = tres.state.device_params.cpu().numpy()
    np.testing.assert_array_equal(jres.state.updated, tres.state.updated)
    hj, ht = jres.history, tres.history
    if quantized:
        scale = float(np.abs(jmat).max())
        assert float(np.abs(jmat - tmat).max()) < 0.05 * scale + 1e-4
        np.testing.assert_allclose(ht.train_loss, hj.train_loss, atol=5e-3)
        np.testing.assert_allclose(ht.gamma_hat, hj.gamma_hat, atol=5e-3)
    else:
        np.testing.assert_allclose(tmat, jmat, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ht.train_loss, hj.train_loss, rtol=1e-5)
        np.testing.assert_allclose(ht.gamma_hat, hj.gamma_hat, rtol=1e-5)
