"""Tensor-parallel serving: ``generate_cached`` on 2 thread ranks over a
model axis (data 1, model 2), greedy, against the JAX package's
``generate_cached`` over its Megatron-sharded variables on 2 virtual
devices (tests/test_generate.py:492, tests/test_quant.py:178) and against
one rank: the tokens exactly, in fp32 (NSA and dense-causal) and int8
(dense-causal; the int8 arrays of the slices are the whole arrays' rows
and columns, and the row-parallel products take whole-row activation
scales and exact int32 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.core import mesh as jmesh
from forde_tpu.models.decoder_lm import FORDEDecoderLM as JDecoderLM
from forde_tpu.models.generate import generate_cached as jgenerate
from forde_tpu.ops.quant import quantize_params as jquantize
from forde_tpu.train.state import _leaf_sharding
from forde_tpu_torch.core import mesh as tmesh
from forde_tpu_torch.models.generate import generate_cached
from forde_tpu_torch.ops.quant import quantize_params
from forde_tpu_torch.parallel import collectives as col
from forde_tpu_torch.train.state import shard_model

from test_torch_decoder_lm import port_model, tiny_config

NEW = 5


def jax_tokens(cfg, variables, prompt, mesh=None):
    if mesh is not None:
        variables = jax.tree_util.tree_map_with_path(
            lambda p, leaf: jax.device_put(leaf, _leaf_sharding(p, leaf, mesh)), variables)
    return np.asarray(jgenerate(JDecoderLM(config=cfg), variables, jnp.asarray(prompt),
                                jax.random.PRNGKey(1), max_new_tokens=NEW, temperature=0.0))


@pytest.mark.parametrize("kind", ["nsa", "causal", "int8"])
def test_tp_generate_cached_matches_jax_and_one_rank(kind):
    cfg = tiny_config(max_seq_len=64, scan_layers=True,
                      use_sparse_attention=kind == "nsa")
    variables = dict(JDecoderLM(config=cfg).init(jax.random.PRNGKey(0),
                                                 jnp.ones((1, 8), jnp.int32)))
    variables = jax.device_get(variables)
    jcfg_ = cfg
    if kind == "int8":
        variables = {"params": jquantize(variables["params"]),
                     "stats_buffer": variables["stats_buffer"]}
        jcfg_ = cfg.replace(quantized=True)
    prompt = np.random.RandomState(0).randint(1, cfg.vocab_size, (2, 6)).astype(np.int32)
    want = jax_tokens(jcfg_, variables, prompt,
                      jmesh.create_mesh(data=1, model=2, devices=jax.devices()[:2]))
    np.testing.assert_array_equal(want, jax_tokens(jcfg_, variables, prompt))  # JAX's claim

    fp_vars = jax.device_get(dict(JDecoderLM(config=cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))))

    def build():
        model = port_model(cfg, fp_vars)
        return quantize_params(model) if kind == "int8" else model

    one = generate_cached(build(), torch.from_numpy(prompt).long(), None,
                          max_new_tokens=NEW, temperature=0.0)

    def rank(r, world):
        mesh = tmesh.Mesh(dict(model=2), r, world)
        model = build()
        whole = {n: p.detach().clone() for n, p in model.named_parameters()}
        layouts, _ = shard_model(model, mesh)
        split = [n for n, sh in layouts.items() if sh.dim_of("model") is not None]
        for n in split:  # a rank's int8/fp arrays are its part of the whole's
            assert torch.equal(dict(model.named_parameters())[n], layouts[n](whole[n])), n
        out = generate_cached(model, torch.from_numpy(prompt).long(), None,
                              max_new_tokens=NEW, temperature=0.0, cuda_graph=False)
        return out, len(split)

    got = col.run_threads(2, rank)
    for out, n_split in got:
        assert n_split >= (6 if kind == "int8" else 10), n_split
        np.testing.assert_array_equal(out.numpy(), want)
        np.testing.assert_array_equal(out.numpy(), one.numpy())
