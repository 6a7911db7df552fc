"""The port's speculative decoding (forde_tpu_torch.models.speculative)
against the JAX package's forde_tpu/models/speculative.py, with the same
weights (test_torch_decoder_lm.py's small config, dense-causal; drafts of
1 layer from other seeds).

The four cases of tests/test_speculative.py, held exactly:
* greedy (temperature 0): the tokens of the target's ``generate_cached``
  and of JAX's ``generate_speculative``, and its stats (rounds, tokens
  generated) equal to JAX's;
* draft = target, greedy: every proposal accepted, rounds =
  ceil(max_new / (gamma + 1)); and sampled (temperature 0.8, top-k 50):
  every proposal accepted too, since p = q (``jax.random`` draws cannot be
  reproduced, so sampling is held by this property);
* an EOS pads the tail with ``pad_id``;
* a ``scan_layers`` target, carried into the port by
  ``interop.split_scan_layers``.
The refusals (NSA, batch 2, overrun) and ``serve --draft_checkpoint_dir``
(JAX's tokens, the tokens/forward line, ``--quantize`` on the draft too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.models import generate as jgen
from forde_tpu.models import speculative as jspec
from forde_tpu.train.checkpoint import save_model_config
from forde_tpu_torch import interop, serve
from forde_tpu_torch.models import generate as tgen
from forde_tpu_torch.models.speculative import generate_speculative

from test_torch_decoder_lm import jax_variables, port_model, tiny_config

torch.set_num_threads(1)


def _mk(seed, **kw):
    cfg = tiny_config(use_sparse_attention=False, **kw)
    model, variables = jax_variables(cfg, seed=seed)
    return cfg, model, variables, port_model(cfg, variables)


@pytest.fixture(scope="module")
def pair():
    return _mk(0), _mk(12345, num_layers=1)


def test_speculative_greedy_matches_target_cached_and_jax(pair):
    (_, model, variables, port), (_, draft, dvars, dport) = pair
    prompt = np.asarray([[5, 17, 200, 9]], np.int32)
    want, want_stats = jspec.generate_speculative(
        model, variables, draft, dvars, jnp.asarray(prompt), jax.random.PRNGKey(2),
        max_new_tokens=10, gamma=3, temperature=0, with_stats=True)
    got, stats = generate_speculative(port, dport, torch.from_numpy(prompt).long(), None,
                                      max_new_tokens=10, gamma=3, temperature=0,
                                      with_stats=True)
    cached = tgen.generate_cached(port, torch.from_numpy(prompt).long(), None,
                                  max_new_tokens=10, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, cached)
    assert stats == {k: int(v) for k, v in want_stats.items()}
    assert stats["generated"] == 10 and stats["rounds"] >= 1


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_speculative_draft_is_target_accepts_everything(pair, temperature):
    (_, model, variables, port), _ = pair
    prompt = torch.tensor([[3, 7]])
    gamma, max_new = 4, 12
    gen = torch.Generator().manual_seed(0)
    got, stats = generate_speculative(port, port, prompt, gen, max_new_tokens=max_new,
                                      gamma=gamma, temperature=temperature, top_k=50,
                                      with_stats=True)
    assert stats == {"rounds": -(-max_new // (gamma + 1)), "generated": max_new}
    assert got.shape == (1, 2 + max_new) and got[0, :2].tolist() == [3, 7]
    if temperature == 0.0:
        want = jgen.generate_cached(model, variables, jnp.asarray(prompt.numpy()),
                                    jax.random.PRNGKey(1), max_new_tokens=max_new,
                                    temperature=0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_speculative_eos_pads_tail(pair):
    (_, _, _, port), _ = pair
    _, _, _, dport = _mk(99, num_layers=1)
    prompt = torch.tensor([[5, 17, 200, 9]])
    ref = tgen.generate_cached(port, prompt, None, max_new_tokens=10, temperature=0.0)
    eos = int(ref[0, 4])
    got = generate_speculative(port, dport, prompt, None, max_new_tokens=10, gamma=3,
                               temperature=0, eos_id=eos, pad_id=0)
    assert got[0, 4] == eos
    assert got[0, 5:].tolist() == [0] * 9


def test_speculative_scan_layers_target():
    _, model, variables, port = _mk(0, scan_layers=True)
    _, draft, dvars, dport = _mk(7, num_layers=1)
    prompt = np.asarray([[2, 4, 6]], np.int32)
    want = jspec.generate_speculative(model, variables, draft, dvars, jnp.asarray(prompt),
                                      jax.random.PRNGKey(2), max_new_tokens=6, gamma=2,
                                      temperature=0)
    got = generate_speculative(port, dport, torch.from_numpy(prompt).long(), None,
                               max_new_tokens=6, gamma=2, temperature=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_speculative_refusals(pair):
    (_, _, _, port), (_, _, _, dport) = pair
    nsa_cfg = tiny_config()
    _, nsa_vars = jax_variables(nsa_cfg)
    nsa = port_model(nsa_cfg, nsa_vars)
    with pytest.raises(ValueError, match="dense-causal"):
        generate_speculative(nsa, dport, torch.tensor([[1, 2]]), max_new_tokens=2)
    with pytest.raises(ValueError, match="batch-1"):
        generate_speculative(port, dport, torch.tensor([[1, 2], [3, 4]]), max_new_tokens=2)
    with pytest.raises(ValueError, match="overruns"):
        generate_speculative(port, dport, torch.tensor([[1] * 40]), max_new_tokens=20)
    with pytest.raises(ValueError, match="gamma"):
        generate_speculative(port, dport, torch.tensor([[1, 2]]), max_new_tokens=2, gamma=0)


def _write(directory, cfg, variables, step):
    save_model_config(directory, cfg, {"step": step})
    np.savez(f"{directory}/params.npz", **interop.flatten(variables))


def test_serve_draft_checkpoint_dir(tmp_path, capsys, pair):
    (cfg, model, variables, _), (dcfg, draft, dvars, _) = pair
    target_dir, draft_dir = str(tmp_path / "target"), str(tmp_path / "draft")
    _write(target_dir, cfg, variables, 4)
    _write(draft_dir, dcfg, dvars, 9)
    prompt = [5, 17, 200, 9, 33]
    argv = ["--checkpoint_dir", target_dir, "--draft_checkpoint_dir", draft_dir, "--gamma", "3",
            "--prompt_ids", ",".join(map(str, prompt)), "--max_new_tokens", "8",
            "--temperature", "0", "--device", "cpu"]
    rows = serve.main(argv)
    out = capsys.readouterr().out
    assert "draft restored step 9 (gamma=3)" in out and "tokens/forward" in out
    want = jspec.generate_speculative(model, variables, draft, dvars,
                                      jnp.asarray([prompt], jnp.int32), jax.random.PRNGKey(0),
                                      max_new_tokens=8, gamma=3, temperature=0)
    assert rows == np.asarray(want).tolist()
    serve.main(argv + ["--quantize", "int8"])
    assert "draft quantized int8 too" in capsys.readouterr().out
