"""The port's evaluation CLI (forde_tpu_torch.eval_lm) against the JAX
package's (forde_tpu.eval_lm), mirroring the checkpoint cases of
tests/test_eval_lm.py:

* a tiny decoder trained by the JAX package's loop with ``--ema_decay``
  (an Orbax checkpoint) is converted into the port's ``params.npz`` by
  scripts/orbax_to_npz.py (params, EMA and stat buffers, through the JAX
  package's own ``load_lm_state``); both CLIs evaluate it on a small text file, with and
  without ``--use_ema``, and print the same JSON: the losses within 1e-5
  relative (fp32 forwards in other orders), the perplexity within 1e-5
  relative of its rounded value, batches and tokens exactly;
* an id past the model's vocabulary is refused; the streamed corpus and
  ``--tokenizer gpt2`` are refused with the training loop's message; with
  no GPU the CLI raises.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from forde_tpu import eval_lm as jeval
from forde_tpu.train import loop as jloop
from forde_tpu_torch import eval_lm

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import orbax_to_npz  # noqa: E402

torch.set_num_threads(1)


def _train_jax(corpus, jax_dir):
    jloop.train(jloop.build_parser().parse_args([
        "--data_file", str(corpus), "--steps_per_epoch", "2", "--num_epochs", "1",
        "--batch_size", "2", "--seq_len", "16", "--d_model", "32", "--num_layers", "1",
        "--num_heads", "2", "--num_experts", "2", "--window_size", "8",
        "--slow_loop_interval", "0", "--log_interval", "1", "--plots_dir", "",
        "--ema_decay", "0.5", "--checkpoint_dir", jax_dir,
    ]))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(JAX checkpoint dir, the port's flattened copy, the corpus)."""
    tmp = tmp_path_factory.mktemp("eval")
    corpus = tmp / "corpus.txt"
    corpus.write_bytes(b"the quick brown fox jumps over the lazy dog. " * 50)
    jax_dir, port_dir = str(tmp / "jax"), str(tmp / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)  # the loop's metrics go to ./runs
        _train_jax(corpus, jax_dir)
    orbax_to_npz.convert(jax_dir, port_dir)
    return jax_dir, port_dir, str(corpus)


@pytest.mark.parametrize("use_ema", [False, True])
def test_eval_json_matches_jax(trained, capsys, use_ema):
    jax_dir, port_dir, corpus = trained
    flags = ["--data_file", corpus, "--batch_size", "2", "--seq_len", "16", "--num_batches",
             "3"] + (["--use_ema"] if use_ema else [])
    want = jeval.evaluate(jeval.build_parser().parse_args(["--checkpoint_dir", jax_dir] + flags))
    capsys.readouterr()
    got = eval_lm.main(["--checkpoint_dir", port_dir, "--device", "cpu"] + flags)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert got["batches"] == want["batches"] == 3
    assert got["tokens"] == want["tokens"] == 3 * 2 * 15
    for key in ("lm_loss", "aux_loss", "perplexity"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_eval_refusals(trained, tmp_path, monkeypatch):
    _, port_dir, corpus = trained
    ids = tmp_path / "ids.npy"
    np.save(ids, np.array([99999, 3, 5] * 20))
    base = ["--checkpoint_dir", port_dir, "--device", "cpu", "--batch_size", "1",
            "--seq_len", "8", "--num_batches", "1"]
    with pytest.raises(ValueError, match="model vocab"):
        eval_lm.main(base + ["--data_file", str(ids)])
    with pytest.raises(NotImplementedError, match="streamed corpus.*tokenizer"):
        eval_lm.main(base)
    with pytest.raises(NotImplementedError, match="gpt2.*tokenizer"):
        eval_lm.main(base + ["--data_file", corpus, "--tokenizer", "gpt2"])
    with pytest.raises(ValueError, match="exceeds"):
        eval_lm.main(base[:-4] + ["--seq_len", "4096", "--use_dummy_data"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert eval_lm.build_parser().parse_args(["--checkpoint_dir", "x"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        eval_lm.main(["--checkpoint_dir", port_dir, "--use_dummy_data"])
