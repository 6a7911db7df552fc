"""The port's int8 serving (forde_tpu_torch.ops.quant and the quantized
decoder) against the JAX package's forde_tpu/ops/quant.py.

* ``quantize_weight`` (2-D and stacked (L,) layouts), ``quantize_activations``
  and the int32 accumulator of ``int8_dense``: exactly equal (integer sums
  are exact, and both frameworks round half to even); ``int8_dense``'s
  fp32 output within 1e-6 relative (the same products, rescaled in the
  same order).
* ``int8_matmul`` within the shapes ``torch._int_mm`` takes on CUDA (more
  than 16 rows, K and N multiples of 8): every test here runs with a
  stand-in for ``torch._int_mm`` that refuses any other shape, so the
  parity tests run the padding the card runs; exactly the plain integer
  product.
* A JAX-quantized tree carried through ``interop`` both ways (unrolled and
  ``scan_layers``), leaf for leaf, and the port's own ``quantize_params``
  of a model equal to JAX's of the same weights.
* Quantized logits of a dense config (dense FFN, and MoE in dense and
  capacity dispatch) and of an NSA config with experts, against the JAX
  package's quantized model. The int8 products agree exactly, but an
  activation whose ``x / scale`` lies within fp32 rounding of a half
  rounds to another int8 in one framework than in the other (JAX's own
  result moves with its XLA flags: under the suite's
  JAX_DISABLE_MOST_OPTIMIZATIONS one such flip shows at seed 3), and the
  flip changes every later position of its row by up to ~5e-3. So the
  bar is per position: at least half of the (row, position) logit
  vectors within atol = rtol = 1e-4 of JAX's (observed 0.60-1.0; 1.0
  with no flip, where the largest difference is ~2e-7), and the
  relative L2 of the whole under the int8-vs-fp control (observed at
  most 0.36 of it). A port that left the activations unquantized reads
  0.0 of the positions. Greedy tokens of ``generate_cached`` and
  ``serve --quantize int8`` equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.models import generate as jgen
from forde_tpu.models.decoder_lm import FORDEDecoderLM as JaxLM
from forde_tpu.ops import quant as jq
from forde_tpu.train.checkpoint import save_model_config
from forde_tpu_torch import interop, serve
from forde_tpu_torch.models import generate as tgen
from forde_tpu_torch.ops import quant as tq

from test_torch_decoder_lm import jax_variables, port_model, tiny_config, token_ids

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def cuda_int_mm_shapes_only(monkeypatch):
    """``torch._int_mm`` refusing what it refuses on CUDA (16 rows or
    fewer, K or N not a multiple of 8); on the CPU it takes any shape."""
    real = torch._int_mm

    def cuda_shapes_only(a, b):
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0, (a.shape, b.shape)
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", cuda_shapes_only)


def test_quantize_weight_matches_jax_2d_and_stacked():
    rng = np.random.RandomState(0)
    for shape in ((64, 32), (3, 16, 8)):
        w = rng.randn(*shape).astype(np.float32)
        w[..., 0] = 0.0  # an all-zero channel takes the 1e-12 floor
        want_q, want_s = jq.quantize_weight(jnp.asarray(w))
        got_q, got_s = tq.quantize_weight(torch.from_numpy(w))
        assert got_q.dtype == torch.int8 and got_s.shape == shape[:-2] + shape[-1:]
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_quantize_activations_matches_jax():
    x = np.random.RandomState(1).randn(4, 5, 48).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1, :3] = 127 * np.float32(0.5) / 127  # values on a rounding half
    want_q, want_s = jq.quantize_activations(jnp.asarray(x))
    got_q, got_s = tq.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_int8_dense_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 64).astype(np.float32)
    w = rng.randn(64, 40).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    q, s = jq.quantize_weight(jnp.asarray(w))
    xq, _ = jq.quantize_activations(jnp.asarray(x))
    want_acc = jax.lax.dot_general(xq, q, (((2,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    got_xq, _ = tq.quantize_activations(torch.from_numpy(x))
    got_acc = tq.int8_matmul(got_xq.reshape(-1, 64), torch.from_numpy(np.array(q)))
    np.testing.assert_array_equal(got_acc.reshape(2, 9, 40).numpy(), np.asarray(want_acc))
    want = np.asarray(jq.int8_dense(jnp.asarray(x), q, s, jnp.asarray(b)))
    got = tq.int8_dense(torch.from_numpy(x), torch.from_numpy(np.array(q)),
                        torch.from_numpy(np.array(s)), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", [(1, 64, 40), (8, 12, 50257 % 64), (5, 512, 57), (40, 24, 16)])
def test_aligned_int_mm_takes_cuda_shapes_and_is_exact(m, k, n):
    rng = np.random.RandomState(m + k + n)
    xq = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    xq[0] = 127  # the largest sums: exact in the fp64 tail too
    w = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int8))
    w[:, :] = torch.where(torch.rand(n, k) < 0.5, w, torch.full_like(w, 127))
    got = tq.int8_matmul(xq, w.t())  # a transposed (N, K) weight, as QDense passes it
    want = xq.to(torch.int64) @ w.t().to(torch.int64)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _quant_pair(seed=0, **kw):
    cfg = tiny_config(**kw)
    model, variables = jax_variables(cfg, seed=seed)
    qcfg = cfg.replace(quantized=True)
    qvars = {"params": jq.quantize_params(variables["params"]),
             "stats_buffer": variables.get("stats_buffer", {})}
    return cfg, model, variables, qcfg, JaxLM(config=qcfg), jax.device_get(qvars)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_jax_quantized_tree_through_interop_both_ways(scan_layers):
    cfg, _, variables, qcfg, _, qvars = _quant_pair(use_sparse_attention=False,
                                                    scan_layers=scan_layers)
    qport = port_model(qcfg, qvars)
    sd = qport.state_dict()
    assert sd["lm_head.weight_q"].dtype == torch.int8 and "lm_head.weight" not in sd
    assert sd["layers.0.moe.moe_layer.experts.w_up_q"].dtype == torch.int8
    want = interop.flatten(interop.split_scan_layers(qvars["params"]))
    back = interop.flatten(interop.state_dict_to_flax(sd)["params"])
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # the port quantizes its own model as JAX quantizes the tree
    mine = tq.quantize_params(port_model(cfg, variables)).state_dict()
    assert sorted(mine) == sorted(sd)
    for k in sd:
        assert torch.equal(mine[k], sd[k]), k


LOGIT_VARIANTS = {
    "dense_moe": dict(use_sparse_attention=False),
    "dense_moe_capacity": dict(use_sparse_attention=False, moe_dispatch="capacity"),
    "dense_ffn": dict(use_sparse_attention=False, use_moe=False),
    "nsa_moe": {},
}


@pytest.mark.parametrize("variant", sorted(LOGIT_VARIANTS))
def test_quantized_logits_match_jax(variant):
    _, model, variables, qcfg, qmodel, qvars = _quant_pair(**LOGIT_VARIANTS[variant])
    ids = token_ids(2, 24, seed=3)
    (want, want_aux), _ = qmodel.apply(qvars, jnp.asarray(ids), mutable=["stats_buffer"])
    (fp, _), _ = model.apply(variables, jnp.asarray(ids), mutable=["stats_buffer"])
    with torch.no_grad():
        got, aux = port_model(qcfg, qvars)(torch.from_numpy(ids))
    got, want, fp = got.numpy(), np.asarray(want), np.asarray(fp)
    close = np.isclose(got, want, **TOL).all(axis=-1)  # (B, S)
    assert close.mean() >= 0.5, close

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(got, want) < rel(want, fp), (rel(got, want), rel(want, fp))
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


@pytest.mark.parametrize("variant", ["dense_moe", "nsa_moe"])
def test_quantized_generate_cached_matches_jax(variant):
    _, _, _, qcfg, qmodel, qvars = _quant_pair(**LOGIT_VARIANTS[variant])
    ids = token_ids(1, 26, seed=4)
    want = jgen.generate_cached(qmodel, qvars, jnp.asarray(ids), jax.random.PRNGKey(0),
                                max_new_tokens=6, temperature=0.0)
    got = tgen.generate_cached(port_model(qcfg, qvars), torch.from_numpy(ids).long(), None,
                               max_new_tokens=6, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantized_model_refuses_random_init():
    from forde_tpu_torch.core import config as tcfg
    from forde_tpu.core import config as jcfg
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM

    cfg = tcfg.config_from_dict(jcfg.config_to_dict(tiny_config(quantized=True)))
    with pytest.raises(ValueError, match="quantize_params"):
        FORDEDecoderLM(cfg, generator=torch.Generator().manual_seed(0))


def test_serve_quantize_int8_matches_jax(tmp_path, capsys):
    """``--quantize int8`` on a JAX-layout checkpoint: the greedy tokens of
    the JAX package's quantized ``generate_cached`` on the same weights."""
    ckpt = str(tmp_path / "ckpt")
    cfg = tiny_config(use_sparse_attention=False)
    _, variables = jax_variables(cfg, seed=5)
    save_model_config(ckpt, cfg, {"step": 2})
    np.savez(f"{ckpt}/params.npz", **interop.flatten(variables))
    prompt = np.random.RandomState(6).randint(1, 256, 20).tolist()
    rows = serve.main(["--checkpoint_dir", ckpt, "--quantize", "int8",
                       "--prompt_ids", ",".join(map(str, prompt)), "--max_new_tokens", "5",
                       "--temperature", "0", "--device", "cpu"])
    assert "int8 weight-only quantization applied" in capsys.readouterr().out
    qvars = {"params": jq.quantize_params(variables["params"]),
             "stats_buffer": variables["stats_buffer"]}
    want = jgen.generate_cached(JaxLM(config=cfg.replace(quantized=True)), qvars,
                                jnp.asarray([prompt], jnp.int32), jax.random.PRNGKey(0),
                                max_new_tokens=5, temperature=0.0)
    assert rows == np.asarray(want).tolist()
