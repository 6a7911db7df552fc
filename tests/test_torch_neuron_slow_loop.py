"""The port's neuron slow loop against the JAX package's: the Forde-lite
assigner, the label canonicalisation, the mode filter, the GMM (started
from the JAX package's own k-means++ means, since ``torch.Generator`` and
``jax.random`` draw different numbers), and a whole Forde-lite brain
update of a small dual encoder, with its resets.

Integer results (assignments, filters, labels) must be equal. The GMM's
means and weights: 1e-4 (fp32 EM in other summation orders over 50
iterations). Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.brain import neuron_slow_loop as jloop
from forde_tpu.brain.smoothing import near_square_grid as jax_near_square_grid
from forde_tpu.brain.smoothing import smooth_assignments as jax_smooth
from forde_tpu.core.config import BrainConfig as JaxBrainConfig
from forde_tpu.ops import gmm as jgmm
from forde_tpu_torch import interop
from forde_tpu_torch.brain import neuron_slow_loop as tloop
from forde_tpu_torch.brain.smoothing import near_square_grid, smooth_assignments
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder
from forde_tpu_torch.nn.stateful import stateful_layers
from forde_tpu_torch.ops import gmm as tgmm

torch.set_num_threads(1)


def _stats5(rng, f):
    """(F, 5) [grad_gini, grad_gdp, act_gini, act_gdp, act_var] that
    straddle the Forde-lite thresholds (0.8 and 0.3)."""
    return np.stack([
        rng.uniform(0.5, 1.0, f), rng.uniform(0, 1, f), rng.uniform(0, 0.6, f),
        rng.uniform(0, 1, f), rng.uniform(0, 2, f),
    ], axis=-1).astype(np.float32)


def test_forde_lite_assignments_exact():
    stats = _stats5(np.random.RandomState(0), 500)
    want = np.asarray(jloop.forde_lite_assignments(jnp.asarray(stats), JaxBrainConfig()))
    got = tloop.forde_lite_assignments(torch.from_numpy(stats), tcfg.BrainConfig())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0, 1, 2}


@pytest.mark.parametrize("case", ["random", "empty_cluster", "tied_means"])
def test_canonicalize_labels_exact(case):
    rng = np.random.RandomState(1)
    a = rng.randint(0, 3, 300).astype(np.int32)
    gini = rng.rand(300).astype(np.float32)
    if case == "empty_cluster":
        a[a == 1] = 2
    if case == "tied_means":
        gini[:] = 0.5
    want = np.asarray(jloop.canonicalize_labels(jnp.asarray(a), jnp.asarray(gini), 3))
    got = tloop.canonicalize_labels(torch.from_numpy(a), torch.from_numpy(gini), 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(48, 64), (32, 64), (2, 3), (1, 5), (4, 4)])
def test_smooth_assignments_exact(shape):
    grid = np.random.RandomState(2).randint(0, 3, shape).astype(np.int32)
    want = np.asarray(jax_smooth(jnp.asarray(grid), kernel_size=3, num_clusters=3))
    got = smooth_assignments(torch.from_numpy(grid), kernel_size=3, num_clusters=3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_smooth_assignments_batched_is_per_grid():
    grids = np.random.RandomState(3).randint(0, 3, (3, 8, 12))
    got = smooth_assignments(torch.from_numpy(grids))
    for i in range(3):
        torch.testing.assert_close(got[i], smooth_assignments(torch.from_numpy(grids[i])))


@pytest.mark.parametrize("n", [3072, 2048, 768, 97, 1])
def test_near_square_grid(n):
    assert near_square_grid(n) == jax_near_square_grid(n)


def _mixture(seed, n=240):
    rng = np.random.RandomState(seed)
    centers = np.array([[0.2, 0.1, 0.3, 0.5, 0.2], [0.6, 0.4, 0.1, 0.2, 0.9],
                        [0.9, 0.8, 0.5, 0.1, 0.4]], np.float32)
    labels = rng.randint(0, 3, n)
    return (centers[labels] + rng.randn(n, 5) * 0.05).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_gmm_from_jax_kmeans_pp_means(seed):
    x = _mixture(seed)
    key = jax.random.PRNGKey(seed)
    init = np.array(jgmm._kmeans_pp_init(jnp.asarray(x), 3, key))
    want_assign, want = jgmm.fit_gmm(jnp.asarray(x), 3, key)
    got_assign, got = tgmm.fit_gmm(torch.from_numpy(x), 3, init_means=torch.from_numpy(init))
    np.testing.assert_array_equal(got_assign.numpy(), np.asarray(want_assign))
    for k in ("means", "weights", "covariances"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4)


def test_gmm_batched_is_per_problem_and_seeded():
    xs = np.stack([_mixture(0), _mixture(1)])
    gen = torch.Generator().manual_seed(0)
    init = tgmm._kmeans_pp_init(torch.from_numpy(xs), 3, gen)
    assign, params = tgmm.fit_gmm(torch.from_numpy(xs), 3, init_means=init)
    for i in range(2):
        a, p = tgmm.fit_gmm(torch.from_numpy(xs[i]), 3, init_means=init[i])
        torch.testing.assert_close(assign[i], a)
        torch.testing.assert_close(params["means"][i], p["means"], atol=1e-6, rtol=1e-6)
    # k-means++ picks data points, and the same seed picks the same ones.
    again = tgmm._kmeans_pp_init(torch.from_numpy(xs), 3, torch.Generator().manual_seed(0))
    torch.testing.assert_close(init, again)
    assert all(
        (init[i, j] == torch.from_numpy(xs[i])).all(-1).any() for i in range(2) for j in range(3)
    )


def _small_model(seed=0):
    tower = tcfg.TowerConfig(d_model=32, num_layers=2, num_heads=1, head_dim=64, mlp_hidden_dim=48)
    text = tcfg.TowerConfig(d_model=32, num_layers=1, num_heads=1, head_dim=64, mlp_hidden_dim=40)
    cfg = tcfg.DualEncoderConfig(
        image_size=32, patch_size=16, vision=tower, text=text, vocab_size=64,
        max_text_len=8, embed_dim=16,
    )
    model = FORDEDualEncoder(cfg)
    rng = np.random.RandomState(seed)
    grad_stats = {}
    with torch.no_grad():
        for i, (name, layer) in enumerate(stateful_layers(model).items()):
            f = layer.neuron_assignments.shape[0]
            steps = 0 if i == 1 else 3  # one layer sensed no step: it keeps its map
            s5 = _stats5(rng, f)
            layer.neuron_assignments.copy_(torch.from_numpy(rng.randint(0, 3, f)))
            layer.act_stats.copy_(torch.from_numpy(s5[:, 2:] * steps))
            layer.step_count.fill_(steps)
            grad_stats[name] = torch.from_numpy(s5[:, :2] * 2)
    return model, grad_stats


def test_forde_lite_slow_loop_matches_jax_and_resets():
    model, grad_stats = _small_model()
    tree = interop.state_dict_to_flax(model.state_dict())
    j_grads = interop.grad_stats_to_flax(grad_stats)
    new_brain, new_stats, new_grads, diag = jloop.neuron_slow_loop_step(
        tree["brain"], tree["stats_buffer"], j_grads, jnp.asarray(2, jnp.int32),
        jax.random.PRNGKey(0), forde_lite=True,
    )
    count = torch.tensor(2, dtype=torch.int32)
    old = {n: l.neuron_assignments.clone() for n, l in stateful_layers(model).items()}
    got = tloop.neuron_slow_loop_step(model, grad_stats, count, forde_lite=True)

    want = interop.flatten(jax.device_get(new_brain))
    port = interop.flatten(interop.state_dict_to_flax(model.state_dict())["brain"])
    assert sorted(port) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(port[k], np.asarray(want[k]), err_msg=k)
    inactive = list(old)[1]
    torch.testing.assert_close(stateful_layers(model)[inactive].neuron_assignments, old[inactive])
    assert not bool(got["skipped"]) and not bool(diag["skipped"])
    for name, layer in stateful_layers(model).items():
        assert layer.act_stats.abs().sum() == 0 and int(layer.step_count) == 0
        assert grad_stats[name].abs().sum() == 0
        d = got["layers"][name]
        jd = diag["layers"][name.replace("blocks.", "block_").replace(".", "/")]
        assert int(d["smoothing_changes"]) == int(jd["smoothing_changes"])
        np.testing.assert_allclose(d["stats"].numpy(), np.asarray(jd["stats"]), rtol=1e-6)
    assert int(count) == 0
    assert all(np.all(np.asarray(v) == 0) for v in jax.tree_util.tree_leaves(new_stats))


def test_gmm_slow_loop_runs_batched_and_skips_when_nothing_was_sensed():
    model, grad_stats = _small_model(seed=1)
    count = torch.tensor(2, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    diag = tloop.neuron_slow_loop_step(model, grad_stats, count, gen, forde_lite=False)
    assert not bool(diag["skipped"])
    for name, d in diag["layers"].items():
        assert d["gmm_weights"].shape == (3,)
        torch.testing.assert_close(d["gmm_weights"].sum(), torch.tensor(1.0), atol=1e-5, rtol=0)
        assert set(d["assignments"].unique().tolist()) <= {0, 1, 2}
    again = tloop.neuron_slow_loop_step(model, grad_stats, count, gen, forde_lite=False)
    assert bool(again["skipped"])
