"""The port's SSD chunked scan against the JAX package's, on the CPU.

``repro_torch.kernels.ssd_scan.ssd_chunked`` on a CPU tensor takes its plain
version (``ssd_chunked_plain``); it is held against the Pallas kernel in
interpret mode (``repro.kernels.ssd_scan.ssd_chunked(..., interpret=True)``)
and against the reference's sequential recurrence, over the shape sweep of
tests/test_kernels_ssd.py plus a grouped B/C case (G < H) and a padded one
(L = 50, chunk 16). The port's own ``ssd_sequential_ref`` is held to the
reference's too.

Tolerance: 2e-4 absolute and relative, as tests/test_kernels_ssd.py holds
the TPU kernel. Every side is float32, summed in another order.

The CUDA kernel is held against the plain version on the card by
tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ssd_scan import ssd_chunked as j_ssd_chunked
from repro.kernels.ssd_scan.ref import ssd_sequential_ref as j_sequential

from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.kernels.ssd_scan.ref import ssd_sequential_ref
from repro_torch.kernels.ssd_scan.ssd_scan import LAUNCHES, reset_launch_counts

TOL = dict(atol=2e-4, rtol=2e-4)

CASES = {                        # b, h, l, p, n, chunk, groups
    "sweep-1x1x16": (1, 1, 16, 8, 8, 8, 1),
    "sweep-2x4x64": (2, 4, 64, 32, 16, 16, 4),
    "sweep-2x2x128": (2, 2, 128, 64, 32, 32, 2),
    "sweep-1x8x96": (1, 8, 96, 16, 16, 32, 8),
    "sweep-p64-n128": (2, 4, 64, 64, 128, 16, 4),
    "grouped-g2-h8": (2, 8, 32, 16, 16, 16, 2),
    "padded-l50-c16": (1, 2, 50, 16, 8, 16, 2),
}


def _inputs(b, h, l, p, n, g, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, l, p)) * 0.8).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, h, l)), 0.0).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    bb = (rng.standard_normal((b, g, l, n)) * 0.5).astype(np.float32)
    cc = (rng.standard_normal((b, g, l, n)) * 0.5).astype(np.float32)
    return x, dt, a_log, bb, cc


@pytest.mark.parametrize("case", list(CASES))
def test_ssd_chunked_matches_jax(case):
    b, h, l, p, n, chunk, g = CASES[case]
    arrays = _inputs(b, h, l, p, n, g)
    x, dt, a_log, bb, cc = arrays
    reset_launch_counts()
    got = ssd_chunked(*map(torch.from_numpy, arrays), chunk=chunk)
    assert LAUNCHES["ssd_scan"] == 0            # a CPU tensor never reaches the kernel
    assert got.shape == (b, h, l, p) and got.dtype == torch.float32

    y_ker = np.asarray(j_ssd_chunked(*map(jnp.asarray, arrays), chunk=chunk, interpret=True))
    np.testing.assert_allclose(got.numpy(), y_ker, **TOL)

    rep = h // g
    b_full, c_full = np.repeat(bb, rep, axis=1), np.repeat(cc, rep, axis=1)
    y_seq = np.asarray(j_sequential(*map(jnp.asarray, (x, dt, a_log, b_full, c_full))))
    np.testing.assert_allclose(got.numpy(), y_seq, **TOL)
    mine_seq = ssd_sequential_ref(*map(torch.from_numpy, (x, dt, a_log, b_full, c_full)))
    np.testing.assert_allclose(mine_seq.numpy(), y_seq, **TOL)


def test_ssd_chunked_refuses_other_devices():
    """The plain version runs only because the tensor lies on the CPU."""
    meta = [torch.from_numpy(a).to("meta") for a in _inputs(1, 2, 16, 8, 8, 1)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ssd_chunked(*meta, chunk=8)
