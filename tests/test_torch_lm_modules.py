"""Pieces of the port's decoder LM against the JAX package's, outside the
whole model: the Sinkhorn projections, the mHC stream modules with the
same parameters, and the Flax tree <-> state_dict round trip of the LM's
trees (unrolled and ``scan_layers``), with the exact per-module map back.

Tolerances: fp32 at 1e-6 (Sinkhorn: a few divisions of a 4 x 4 matrix)
and 1e-5 (the stream modules: one Dense and two small einsums); the
round trip is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu_torch import interop

from test_torch_decoder_lm import jax_variables, tiny_config

torch.set_num_threads(1)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_interop_round_trip_decoder_lm(scan_layers):
    """JAX tree -> state_dict -> JAX tree gives back every leaf exactly
    (the unrolled layout; a scan_layers tree comes back unrolled):
    pos_embed stays an untransposed ``embedding``, the expert banks stay
    untransposed, the stat buffers keep their dtypes."""
    cfg = tiny_config(scan_layers=scan_layers)
    _, variables = jax_variables(cfg)
    params = interop.split_scan_layers(variables["params"])
    stats = interop.split_scan_layers(variables["stats_buffer"])
    state = interop.flax_to_state_dict(params, {}, stats_buffer=stats)
    back = interop.state_dict_to_flax(state)
    want = interop.flatten({"params": params, "stats_buffer": stats})
    got = interop.flatten({"params": back["params"], "stats_buffer": back["stats_buffer"]})
    assert sorted(got) == sorted(want) and back["brain"] == {}
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert "params/pos_embed/embedding" in got
    assert got["params/pos_embed/embedding"].shape == (cfg.max_seq_len, cfg.d_model)
    if scan_layers:
        assert np.asarray(variables["params"]["layers"]["block"]["attn_norm"]["scale"]).shape[0] == 2


def test_interop_weight_of_unknown_module_raises():
    with pytest.raises(KeyError, match="mystery"):
        interop.state_dict_to_flax({"mystery.weight": torch.zeros(2, 2)})


def test_sinkhorn_matches_jax():
    from forde_tpu.ops import sinkhorn as jsk
    from forde_tpu_torch.ops import sinkhorn as tsk

    logits = np.random.RandomState(8).randn(4, 4).astype(np.float32)
    for j, t in ((lambda x: jsk.sinkhorn_knopp(x, 5), lambda x: tsk.sinkhorn_knopp(x, 5)),
                 (lambda x: jsk.sinkhorn_knopp_exp(x, 3, 0.7),
                  lambda x: tsk.sinkhorn_knopp_exp(x, 3, 0.7))):
        want = np.asarray(j(jnp.asarray(logits)))
        np.testing.assert_allclose(t(torch.from_numpy(logits)).numpy(), want, atol=1e-6)


@pytest.mark.parametrize("method", ["weighted_sum", "concat", "first"])
def test_stream_modules_match_jax(method):
    """HyperConnectionStream, ManifoldHyperConnection and each
    StreamCollapser method with the same parameters as the JAX modules."""
    from forde_tpu.nn import hyper_connections as jhc
    from forde_tpu_torch.nn import hyper_connections as thc

    rng = np.random.RandomState(9)
    x = rng.randn(2, 5, 16).astype(np.float32)
    sub = rng.randn(2, 5, 16).astype(np.float32)
    key = jax.random.PRNGKey(0)
    expand = jhc.HyperConnectionStream(num_streams=3, d_model=16)
    ve = expand.init(key, jnp.asarray(x))
    streams = expand.apply(ve, jnp.asarray(x))
    mix = jhc.ManifoldHyperConnection(num_streams=3, sinkhorn_iterations=4)
    vm = mix.init(key, streams, jnp.asarray(sub))
    mixed, out = mix.apply(vm, streams, jnp.asarray(sub))
    coll = jhc.StreamCollapser(d_model=16, collapse_method=method)
    vc = coll.init(key, mixed)
    collapsed = coll.apply(vc, mixed)

    t_expand = thc.HyperConnectionStream(3, 16)
    t_expand.load_state_dict(interop.flax_to_state_dict(ve["params"], {}))
    t_mix = thc.ManifoldHyperConnection(3, 4)
    t_mix.load_state_dict(interop.flax_to_state_dict(vm["params"], {}))
    t_coll = thc.StreamCollapser(16, 3, method)
    t_coll.load_state_dict(interop.flax_to_state_dict(vc.get("params", {}), {}))
    with torch.no_grad():
        t_streams = t_expand(torch.from_numpy(x))
        t_mixed, t_out = t_mix(t_streams, torch.from_numpy(sub))
        t_collapsed = t_coll(t_mixed)
    for got, want in ((t_streams, streams), (t_mixed, mixed), (t_out, out),
                      (t_collapsed, collapsed)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
