"""The port's copies of the reference's small public functions, held
against the JAX package's: ``ArchConfig.active_param_count`` /
``is_ssm_only`` / ``sub_quadratic`` / ``with_sliding_window`` for every
registry id, ``FederatedDataset.client_batch``, and the two estimators
``heterogeneity.delta_squared`` and ``walk.gamma_inexactness``. All exact:
they are integer arithmetic, numpy draws on one seed, or one float64
division."""
import dataclasses

import numpy as np
import pytest

from repro.configs import ARCH_IDS as J_ARCH_IDS, get_arch as j_get_arch
from repro.core.heterogeneity import delta_squared as j_delta_squared
from repro.core.heterogeneity import partition_similarity as j_partition
from repro.core.walk import gamma_inexactness as j_gamma_inexactness
from repro.data import FederatedDataset as JData
from repro.data import synthetic_image_classification as j_synth

from repro_torch.configs import ARCH_IDS, get_arch, get_smoke
from repro_torch.core.heterogeneity import delta_squared, partition_similarity
from repro_torch.core.walk import gamma_inexactness
from repro_torch.data import FederatedDataset, synthetic_image_classification


def test_registry_ids_equal():
    assert list(ARCH_IDS) == list(J_ARCH_IDS)
    assert len(ARCH_IDS) == 10      # the LM registry; the FNN and LSTM are not ArchConfigs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_methods_match(arch):
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.is_ssm_only == jcfg.is_ssm_only
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    assert cfg.has_attention == jcfg.has_attention
    assert cfg.active_param_count() <= cfg.param_count()
    if cfg.moe is None:
        assert cfg.active_param_count() == cfg.param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_with_sliding_window_field_by_field(arch):
    got = dataclasses.asdict(get_arch(arch).with_sliding_window(8192))
    want = dataclasses.asdict(j_get_arch(arch).with_sliding_window(8192))
    assert got == want
    assert got["sliding_window"] == 8192
    assert get_arch(arch).with_sliding_window(8192).sub_quadratic


def test_smoke_methods_match():
    from repro.configs import get_smoke as j_get_smoke

    for arch in ARCH_IDS:
        assert get_smoke(arch).active_param_count() == j_get_smoke(arch).active_param_count()


@pytest.mark.parametrize("seed", [0, 7])
def test_client_batch_matches(seed):
    x, y = j_synth(n_samples=600, seed=0)
    jdata = JData.from_partition(x, y, j_partition(y, 6, 50, np.random.default_rng(0)))
    xt, yt = synthetic_image_classification(n_samples=600, seed=0)
    tdata = FederatedDataset.from_partition(
        xt, yt, partition_similarity(yt, 6, 50, np.random.default_rng(0)))
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for client in (0, 3, 5):
        jx, jy = jdata.client_batch(client, 17, jr)
        tx, ty = tdata.client_batch(client, 17, tr)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    assert jr.bit_generator.state == tr.bit_generator.state


@pytest.mark.parametrize("local,glob", [
    (np.array([1.0, 2.0, 3.5]), 1.25),
    (np.array([0.0, 0.0]), 0.0),          # zero global norm: the IID value 1
    (np.array([4.0]), -1.0),
    (np.array([0.3, 0.7, 0.1, 2.2]), 1e-9),
])
def test_delta_squared_matches(local, glob):
    assert delta_squared(local, glob) == j_delta_squared(local, glob)
    assert isinstance(delta_squared(local, glob), float)


@pytest.mark.parametrize("end,start", [(0.5, 2.0), (3.0, 0.0), (1.0, -1.0), (0.0, 1.0),
                                       (7.25, 1e-12)])
def test_gamma_inexactness_matches(end, start):
    assert gamma_inexactness(end, start) == j_gamma_inexactness(end, start)
    assert isinstance(gamma_inexactness(end, start), float)
