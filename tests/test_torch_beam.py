"""The port's beam search (forde_tpu_torch.models.generate.generate_beam)
against the JAX package's, with the same weights (test_torch_decoder_lm.py's
small config: window 16, compression ratio 4, top-k 8, max_seq_len 64).

* The best beam, token for token equal to JAX's ``generate_beam``, for a
  dense and an NSA config (prompts past the window, so that every NSA
  branch runs), with and without ``eos_id`` and ``length_penalty``.
* The best beam rescored by the port's own cached decode (``nsa_prefill``
  or the dense prefill, then one decode step per token) within 1e-5
  (absolute) of the same sequence scored by the JAX package's: the summed
  fp32 logprobs up to and including the EOS, over
  gen_len ** length_penalty.
* ``beam_size`` 1 is the greedy ``generate_cached``, and the 4-beam best,
  rescored by the port's cached decode, scores at least the greedy path
  (the property of tests/test_generate.py).
* ``serve --beam_size`` gives JAX's best beam; with ``--prompts_file`` it
  is refused, as in the reference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.models import generate as jgen
from forde_tpu.train.checkpoint import save_model_config
from forde_tpu_torch import interop, serve
from forde_tpu_torch.models import generate as tgen

from test_torch_decoder_lm import jax_variables, port_model, tiny_config

torch.set_num_threads(1)

NEW = 6
SCORE_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup(variant):
    cfg = tiny_config(use_sparse_attention=variant == "nsa")
    model, variables = jax_variables(cfg, seed=2)
    return model, variables, port_model(cfg, variables)


def _prompt(seed, b=2, p=20):
    return np.random.RandomState(seed).randint(1, 256, (b, p)).astype(np.int32)


def _jax_score(model, variables, prompt, new, eos_id, length_penalty):
    """(1, P) prompt, (N,) generated ids -> the beam score of the JAX
    package's cached decode over them."""
    mv = {"params": variables["params"], "stats_buffer": variables.get("stats_buffer", {})}
    if model.config.use_sparse_attention:
        cache, last = jax.jit(jgen.nsa_prefill, static_argnums=0)(model, variables, prompt)
    else:
        cache = model.init(jax.random.PRNGKey(0), prompt, None, True, True)["cache"]
        (logits, _), upd = model.apply({**mv, "cache": cache}, prompt, None, True, True,
                                       mutable=["cache", "stats_buffer"])
        cache, last = upd["cache"], logits[:, -1, :]

    @jax.jit
    def step(cache, token):
        (logits, _), upd = model.apply({**mv, "cache": cache}, token, None, True, True,
                                       mutable=["cache", "stats_buffer"])
        return logits[:, 0, :], upd["cache"]

    total, length = 0.0, 0
    for i, tok in enumerate(new):
        total += float(jax.nn.log_softmax(last.astype(jnp.float32), axis=-1)[0, tok])
        length += 1
        if eos_id is not None and tok == eos_id:
            break
        if i + 1 < len(new):
            last, cache = step(cache, jnp.asarray([[tok]], jnp.int32))
    return total / length ** length_penalty if length_penalty else total


@torch.no_grad()
def _port_score(port, prompt, new, eos_id, length_penalty):
    """(B, P) prompt, (B, N) generated ids -> (B,) beam scores of the port's
    cached decode over them (``_jax_score``'s rule, all rows at once)."""
    b = prompt.shape[0]
    if port.config.use_sparse_attention:
        cache, last = tgen.nsa_prefill(port, prompt)
    else:
        cache = port.init_cache(b)
        logits, _ = port(prompt, cache=cache)
        last = logits[:, -1, :]
    total = torch.zeros(b, dtype=torch.float64)
    length = torch.zeros(b, dtype=torch.int64)
    live = torch.ones(b, dtype=torch.bool)
    for i in range(new.shape[1]):
        tok = new[:, i]
        lp = torch.log_softmax(last.float(), dim=-1).gather(1, tok[:, None])[:, 0]
        total += torch.where(live, lp.double(), 0.0)
        length += live.long()
        if eos_id is not None:
            live &= tok != eos_id
        if i + 1 < new.shape[1]:
            logits, _ = port(tok[:, None], cache=cache)
            last = logits[:, 0, :]
    return total / length.double() ** length_penalty if length_penalty else total


@pytest.mark.parametrize("variant", ["dense", "nsa"])
@pytest.mark.parametrize("eos,penalty", [(False, 0.0), (True, 0.6)])
def test_generate_beam_matches_jax(variant, eos, penalty):
    model, variables, port = _setup(variant)
    prompt = _prompt(3)
    eos_id = None
    if eos:
        # the first token of row 0's best beam, so that the EOS fires
        free = tgen.generate_beam(port, torch.from_numpy(prompt).long(), max_new_tokens=2,
                                  beam_size=3)
        eos_id = int(free[0, prompt.shape[1]])
    want = jgen.generate_beam(model, variables, jnp.asarray(prompt), max_new_tokens=NEW,
                              beam_size=3, length_penalty=penalty, eos_id=eos_id, pad_id=0)
    got = tgen.generate_beam(port, torch.from_numpy(prompt).long(), max_new_tokens=NEW,
                             beam_size=3, length_penalty=penalty, eos_id=eos_id, pad_id=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p = prompt.shape[1]
    if eos:
        assert (got[:, p:] == eos_id).any()
    scores = _port_score(port, got[:, :p], got[:, p:], eos_id, penalty)
    for i in range(prompt.shape[0]):
        ref = _jax_score(model, variables, jnp.asarray(prompt[i:i + 1]),
                         got[i, p:].tolist(), eos_id, penalty)
        assert abs(float(scores[i]) - ref) <= SCORE_ATOL, (i, float(scores[i]), ref)


@pytest.mark.parametrize("variant", ["dense", "nsa"])
def test_beam_one_is_greedy_and_four_beams_score_higher(variant):
    _, _, port = _setup(variant)
    prompt = torch.from_numpy(_prompt(4)).long()
    greedy = tgen.generate_cached(port, prompt, None, max_new_tokens=NEW, temperature=0.0)
    beam1 = tgen.generate_beam(port, prompt, max_new_tokens=NEW, beam_size=1)
    assert torch.equal(beam1, greedy)
    beam4 = tgen.generate_beam(port, prompt, max_new_tokens=NEW, beam_size=4)
    p = prompt.shape[1]
    assert torch.equal(beam4[:, :p], prompt)
    s4, s1 = (_port_score(port, prompt, ids[:, p:], None, 0.0) for ids in (beam4, greedy))
    assert (s4 >= s1 - 1e-6).all(), (s4, s1)


def test_serve_beam_size_matches_jax(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    cfg = tiny_config()
    model, variables = jax_variables(cfg, seed=6)
    save_model_config(ckpt, cfg, {"step": 1})
    np.savez(f"{ckpt}/params.npz", **interop.flatten(variables))
    prompt = _prompt(5, b=1)
    rows = serve.main(["--checkpoint_dir", ckpt, "--prompt_ids", ",".join(map(str, prompt[0])),
                       "--beam_size", "3", "--length_penalty", "0.6", "--eos_id", "7",
                       "--max_new_tokens", str(NEW), "--device", "cpu"])
    want = jgen.generate_beam(model, variables, jnp.asarray(prompt), max_new_tokens=NEW,
                              beam_size=3, length_penalty=0.6, eos_id=7)
    assert rows == np.asarray(want).tolist()
    pf = tmp_path / "prompts.txt"
    pf.write_text("5,17,20\n")
    with pytest.raises(SystemExit, match="prompts_file"):
        serve.main(["--checkpoint_dir", ckpt, "--prompts_file", str(pf), "--beam_size", "2",
                    "--device", "cpu"])
