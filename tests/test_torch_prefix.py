"""The port's prefix caching (forde_tpu_torch.models.generate
``prefill_prefix``, ``tile_prefix_cache``, ``prefix_cache=``) against the
JAX package's, with the same weights (test_torch_decoder_lm.py's small
config, dense-causal, max_seq_len 64).

Greedy tokens (temperature 0) are held exactly: ``generate_cached`` and
``generate_ragged`` continuing from a prefix cache equal the JAX
package's on the same prefix and the port's own decode of the
concatenated prompt. The prefix cache is left exactly as it was after two
calls (the decode writes its cache in place, so the tiling must copy).
NSA configs are refused, as in the reference. ``serve --prefix_ids``
gives the JAX package's tokens, and refuses beam search, speculative
decoding and NSA configs with it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.models import generate as jgen
from forde_tpu_torch import serve
from forde_tpu_torch.models import generate as tgen

from test_torch_decoder_lm import jax_variables, port_model, tiny_config

torch.set_num_threads(1)

NEW = 6


def _dense(scan_layers=False):
    cfg = tiny_config(use_sparse_attention=False, scan_layers=scan_layers)
    model, variables = jax_variables(cfg)
    return cfg, model, variables, port_model(cfg, variables)


def _flat(cache, prefix=""):
    out = {}
    for k, v in cache.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("scan_layers", [False, True])
def test_generate_cached_prefix_matches_jax_and_concatenation(scan_layers):
    _, model, variables, port = _dense(scan_layers)
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, 256, (1, 7)).astype(np.int32)
    sufs = rng.randint(1, 256, (2, 5)).astype(np.int32)
    pc = jgen.prefill_prefix(model, variables, jnp.asarray(prefix))
    want = jgen.generate_cached(model, variables, jnp.asarray(sufs), jax.random.PRNGKey(0),
                                max_new_tokens=NEW, temperature=0.0, prefix_cache=pc)
    tpc = tgen.prefill_prefix(port, torch.from_numpy(prefix).long())
    got = tgen.generate_cached(port, torch.from_numpy(sufs).long(), None, max_new_tokens=NEW,
                               temperature=0.0, prefix_cache=tpc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    whole = np.concatenate([np.repeat(prefix, 2, 0), sufs], axis=1)
    concat = tgen.generate_cached(port, torch.from_numpy(whole).long(), None,
                                  max_new_tokens=NEW, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), concat[:, prefix.shape[1]:].numpy())


def test_generate_ragged_prefix_matches_jax_and_concatenation():
    _, model, variables, port = _dense()
    rng = np.random.RandomState(1)
    prefix = rng.randint(1, 256, (1, 9)).astype(np.int32)
    sufs = [rng.randint(1, 256, (n,)).tolist() for n in (3, 6, 1)]
    lens = np.array([len(s) for s in sufs], np.int32)
    padded = np.zeros((3, lens.max()), np.int32)
    for i, s in enumerate(sufs):
        padded[i, : len(s)] = s
    pc = jgen.prefill_prefix(model, variables, jnp.asarray(prefix))
    want = jgen.generate_ragged(model, variables, jnp.asarray(padded), jnp.asarray(lens),
                                jax.random.PRNGKey(0), max_new_tokens=NEW, temperature=0.0,
                                prefix_cache=pc)
    tpc = tgen.prefill_prefix(port, torch.from_numpy(prefix).long())
    got = tgen.generate_ragged(port, torch.from_numpy(padded).long(), torch.from_numpy(lens),
                               None, max_new_tokens=NEW, temperature=0.0, prefix_cache=tpc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i, s in enumerate(sufs):
        whole = torch.tensor([prefix[0].tolist() + s])
        concat = tgen.generate_cached(port, whole, None, max_new_tokens=NEW, temperature=0.0)
        assert got[i, : len(s) + NEW].tolist() == concat[0, prefix.shape[1]:].tolist(), i


def test_prefix_cache_unchanged_after_two_calls():
    """Two calls from one prefix cache (batch 1, then a ragged batch of 2)
    leave every leaf of it as it was, counters included; the tiled cache
    is new storage."""
    _, _, _, port = _dense()
    tpc = tgen.prefill_prefix(port, torch.tensor([[5, 17, 200, 9]]))
    before = {k: v.clone() for k, v in _flat(tpc).items()}
    first = tgen.generate_cached(port, torch.tensor([[3, 4]]), None, max_new_tokens=NEW,
                                 temperature=0.0, prefix_cache=tpc)
    tgen.generate_ragged(port, torch.tensor([[3, 4], [8, 0]]), torch.tensor([2, 1]), None,
                         max_new_tokens=NEW, temperature=0.0, prefix_cache=tpc)
    again = tgen.generate_cached(port, torch.tensor([[3, 4]]), None, max_new_tokens=NEW,
                                 temperature=0.0, prefix_cache=tpc)
    assert torch.equal(first, again)
    after = _flat(tpc)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert int(tgen.prefix_length(tpc)) == 4
    tiled = _flat(tgen.tile_prefix_cache(tpc, 1))
    assert all(tiled[k].data_ptr() != t.data_ptr() for k, t in after.items())


def test_prefix_caching_refuses_nsa():
    nsa_cfg = tiny_config()
    _, nsa_vars = jax_variables(nsa_cfg)
    nsa = port_model(nsa_cfg, nsa_vars)
    with pytest.raises(ValueError, match="dense-causal"):
        tgen.prefill_prefix(nsa, torch.tensor([[1, 2, 3]]))
    _, _, _, dense = _dense()
    tpc = tgen.prefill_prefix(dense, torch.tensor([[1, 2, 3]]))
    with pytest.raises(ValueError, match="dense-causal"):
        tgen.generate_cached(nsa, torch.tensor([[4, 5]]), None, max_new_tokens=2,
                             temperature=0.0, prefix_cache=tpc)
    with pytest.raises(ValueError, match="dense-causal"):
        tgen.generate_ragged(nsa, torch.tensor([[4, 5]]), torch.tensor([2]), None,
                             max_new_tokens=2, temperature=0.0, prefix_cache=tpc)
    with pytest.raises(ValueError, match="one sequence"):
        tgen.prefill_prefix(dense, torch.tensor([[1, 2], [3, 4]]))


SHAPE = ["--d_model", "32", "--num_layers", "1", "--num_heads", "2", "--num_experts", "2",
         "--window_size", "8", "--seq_len", "64", "--max_new_tokens", "3",
         "--temperature", "0", "--device", "cpu"]


def test_serve_prefix_ids(tmp_path, capsys):
    """--prefix_ids: the single-prompt and the ragged batch paths reuse the
    prefix and print prompt + continuation only, and a row of the batch
    equals the single prompt's; the tokens equal the port's decode of the
    concatenated prompt."""
    rows = serve.main([*SHAPE, "--no_nsa", "--prompt_ids", "5,17,20", "--prefix_ids", "8,1,9"])
    assert "shared prefix prefilled once (3 tokens)" in capsys.readouterr().out
    assert rows[0][:3] == [5, 17, 20] and len(rows[0]) == 6
    whole = serve.main([*SHAPE, "--no_nsa", "--prompt_ids", "8,1,9,5,17,20"])
    assert whole[0][3:] == rows[0]
    pf = tmp_path / "prompts.txt"
    pf.write_text("5,17,20\n9,9\n")
    batch = serve.main([*SHAPE, "--no_nsa", "--prompts_file", str(pf), "--prefix_ids", "8,1,9"])
    assert batch[0] == rows[0] and batch[1][:2] == [9, 9] and len(batch[1]) == 5


@pytest.mark.parametrize("flags,match", [
    ([], "dense-causal"),  # NSA, the flags' default
    (["--no_nsa", "--beam_size", "2"], "greedy/sampled"),
    (["--no_nsa", "--draft_checkpoint_dir", "x"], "greedy/sampled"),
])
def test_serve_prefix_ids_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        serve.main([*SHAPE, *flags, "--prompt_ids", "5,17", "--prefix_ids", "8,1"])
