"""The port's decoder LM (forde_tpu_torch.models.decoder_lm) against the
JAX package's, with the same weights.

A small config (2 layers, d=32, 2 heads of 16, 4 experts, window 16,
compression ratio 4, top-k 8, 2 streams; the shape of the JAX package's
own decoder tests) is initialised in JAX, and ``interop`` carries its
``params`` and ``stats_buffer`` into the port. Token ids come from numpy
with a seed, at lengths past window + ratio so that all three NSA
branches run. The JAX side runs its attention ``impl="reference"``; the
port runs "auto", which on CPU tensors is the kernels' plain versions
(head_dim 16 padded to 64 as on the card).

Tolerances: fp32 logits within atol = rtol = 1e-4 (matmuls summed in
other orders through 2 layers; observed ~4e-7 relative L2). bf16
compares the relative L2 of the logits against the JAX package's own
bf16 run, which must be under half of the control, JAX bf16 against
JAX fp32 on the same weights (observed 0.040 against a control of
0.122): both frameworks round every activation to bf16, but at other
places (a bf16 matmul's output, the order of a bf16 add), and the MoE
router picks another expert for a token whose top-2 logits lie within a
bf16 rounding, which moves the logits far more than the roundings do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.core import config as jcfg
from forde_tpu.models.decoder_lm import FORDEDecoderLM as JaxLM
from forde_tpu_torch import interop
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_OF_CONTROL = 0.5


def tiny_config(cfg_mod=jcfg, **kw):
    base = dict(
        vocab_size=256, d_model=32, num_layers=2, num_heads=2, head_dim=16,
        max_seq_len=64, num_experts=4, top_k_experts=2, expert_hidden_dim=64,
        window_size=16, compression_ratio=4, top_k_global=8, num_streams=2,
        sinkhorn_iterations=3, dropout_rate=0.0, attention_impl="reference",
    )
    base.update(kw)
    return cfg_mod.LLMConfig(**base)


def jax_variables(cfg, seed=0):
    model = JaxLM(config=cfg)
    variables = model.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))
    return model, jax.device_get(variables)


def port_model(jax_cfg, variables, impl="auto"):
    """The port's model holding the JAX variables (``stats_buffer``
    included)."""
    cfg = tcfg.config_from_dict(jcfg.config_to_dict(jax_cfg)).replace(attention_impl=impl)
    model = FORDEDecoderLM(cfg)
    state = interop.flax_to_state_dict(
        interop.split_scan_layers(variables["params"]), {},
        expected=model.state_dict(),
        stats_buffer=interop.split_scan_layers(variables.get("stats_buffer", {})),
    )
    model.load_state_dict(state)
    return model.eval()


def token_ids(b, s, vocab=256, seed=0):
    return np.random.RandomState(seed).randint(1, vocab, (b, s)).astype(np.int32)


VARIANTS = {
    "nsa_moe_mhc": {},
    "no_moe": dict(use_moe=False),
    "no_nsa": dict(use_sparse_attention=False),
    "no_mhc": dict(use_hyper_connections=False),
    "reference_quirks": dict(reference_quirks=True),
    "streams_4": dict(num_streams=4),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax_fp32(variant):
    cfg = tiny_config(**VARIANTS[variant])
    model, variables = jax_variables(cfg)
    ids = token_ids(2, 40)
    (want, want_aux), _ = model.apply(variables, jnp.asarray(ids), mutable=["stats_buffer"])
    with torch.no_grad():
        got, aux = port_model(cfg, variables)(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_forward_matches_jax_bf16():
    cfg = tiny_config(dtypes=jcfg.DTypePolicy.bf16())
    model, variables = jax_variables(cfg)
    ids = jnp.asarray(token_ids(2, 40, seed=1))
    (want, _), _ = model.apply(variables, ids, mutable=["stats_buffer"])
    (fp32, _), _ = JaxLM(config=tiny_config()).apply(variables, ids, mutable=["stats_buffer"])
    with torch.no_grad():
        got, _ = port_model(cfg, variables)(torch.from_numpy(np.array(ids)))
    want = np.asarray(want, np.float32)

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    control = rel(want, np.asarray(fp32))
    assert got.dtype == torch.float32
    assert rel(got.numpy(), want) < BF16_OF_CONTROL * control, (rel(got.numpy(), want), control)


def test_ragged_forward_matches_jax():
    """``lengths``: the ragged forward's logits at every real position,
    lengths straddling the gates (window 16, ratio 4)."""
    cfg = tiny_config()
    model, variables = jax_variables(cfg)
    ids = token_ids(4, 32, seed=2)
    lens = np.array([5, 18, 26, 32], np.int32)
    (want, _), _ = model.apply(
        variables, jnp.asarray(ids), lengths=jnp.asarray(lens), mutable=["stats_buffer"]
    )
    with torch.no_grad():
        got, _ = port_model(cfg, variables)(torch.from_numpy(ids), lengths=torch.from_numpy(lens))
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n].numpy(), np.asarray(want)[i, :n], **TOL)


def test_expert_usage_update_matches_jax():
    """The MoE sensing buffers: two updated calls against JAX's returned
    ``stats_buffer``."""
    cfg = tiny_config()
    model, variables = jax_variables(cfg)
    port = port_model(cfg, variables)
    stats = variables["stats_buffer"]
    for seed in (3, 4):
        ids = token_ids(2, 24, seed=seed)
        _, upd = model.apply(
            {"params": variables["params"], "stats_buffer": stats}, jnp.asarray(ids),
            mutable=["stats_buffer"],
        )
        stats = upd["stats_buffer"]
        with torch.no_grad():
            port(torch.from_numpy(ids), update_stats=True)
    for i in range(cfg.num_layers):
        moe = port.layers[i].moe
        want = stats[f"layer_{i}"]["moe"]
        np.testing.assert_allclose(moe.expert_usage.numpy(), np.asarray(want["expert_usage"]),
                                   atol=1e-6)
        assert int(moe.step_count) == int(want["step_count"]) == 2
    # serving leaves the buffers as loaded
    before = port.layers[0].moe.expert_usage.clone()
    with torch.no_grad():
        port(torch.from_numpy(token_ids(1, 8)))
    assert torch.equal(port.layers[0].moe.expert_usage, before)


def test_moe_dispatch_capacity_not_ported():
    """Capacity dispatch is ported: a model with capacity factor 0.5 (a
    quarter of the routed choices overflow and drop) gives the JAX
    package's logits and aux loss."""
    cfg = tiny_config(moe_dispatch="capacity", moe_capacity_factor=0.5)
    model, variables = jax_variables(cfg)
    ids = token_ids(2, 40, seed=5)
    (want, want_aux), _ = model.apply(variables, jnp.asarray(ids), mutable=["stats_buffer"])
    with torch.no_grad():
        got, aux = port_model(cfg, variables)(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    dense = tiny_config()
    (other, _), _ = JaxLM(config=dense).apply(variables, jnp.asarray(ids), mutable=["stats_buffer"])
    assert np.abs(np.asarray(other) - np.asarray(want)).max() > 1e-3  # the drops matter
    # "ep" dispatch is ported (parallel/expert_parallel.py) and, as in the
    # JAX package, needs a mesh: a model without one refuses to run it
    ep = FORDEDecoderLM(tcfg.config_from_dict(jcfg.config_to_dict(tiny_config(moe_dispatch="ep"))))
    with pytest.raises(ValueError, match="requires a mesh"):
        ep(torch.from_numpy(ids))


def test_random_init_is_seeded_and_finite():
    cfg = tcfg.config_from_dict(jcfg.config_to_dict(tiny_config()))
    a = FORDEDecoderLM(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    b = FORDEDecoderLM(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["layers.0.mhc_attn.mixing_logits"].abs().max() > 0
    assert torch.equal(a["stream_collapser.stream_weights"], torch.ones(2))
    model = FORDEDecoderLM(cfg, generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(token_ids(1, 30)))
    assert torch.isfinite(logits).all()

