"""The port's serving CLI (forde_tpu_torch.serve) on the CPU, serving a
checkpoint in the JAX package's layout.

A small NSA + MoE + mHC decoder (test_torch_decoder_lm.py's config,
window 16) is initialised in JAX, unrolled or with ``scan_layers``; its
``params`` and ``stats_buffer`` trees are written as ``params.npz``
beside the JAX package's ``model_config.json``. ``serve.main`` then
decodes greedily from ``--prompt_ids`` and from a ``--prompts_file`` of
mixed lengths, prompts past the window; the tokens must equal the JAX
package's ``generate_cached`` / ``generate_ragged`` on the same weights
exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.models import generate as jgen
from forde_tpu.train.checkpoint import save_model_config
from forde_tpu_torch import interop, serve

from test_torch_decoder_lm import jax_variables, tiny_config

torch.set_num_threads(1)

NEW = 6


def _write_jax_checkpoint(directory, scan_layers):
    cfg = tiny_config(scan_layers=scan_layers)
    model, variables = jax_variables(cfg, seed=7)
    save_model_config(directory, cfg, {"step": 11})
    np.savez(f"{directory}/params.npz", **interop.flatten(variables))
    return model, variables


@pytest.mark.parametrize("scan_layers", [False, True])
def test_serve_prompt_ids_matches_jax(tmp_path, capsys, scan_layers):
    ckpt = str(tmp_path / "ckpt")
    model, variables = _write_jax_checkpoint(ckpt, scan_layers)
    prompt = np.random.RandomState(0).randint(1, 256, 24).tolist()
    rows = serve.main([
        "--checkpoint_dir", ckpt, "--prompt_ids", ",".join(map(str, prompt)),
        "--max_new_tokens", str(NEW), "--temperature", "0", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "restored step 11" in out and "token ids:" in out
    want = jgen.generate_cached(model, variables, jnp.asarray([prompt], jnp.int32),
                                jax.random.PRNGKey(0), max_new_tokens=NEW, temperature=0.0)
    assert rows == np.asarray(want).tolist()


def test_serve_prompts_file_matches_jax_ragged(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    model, variables = _write_jax_checkpoint(ckpt, False)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 256, n).tolist() for n in (30, 9, 21)]
    pfile, ofile = tmp_path / "prompts.txt", tmp_path / "out.jsonl"
    pfile.write_text("".join(",".join(map(str, p)) + "\n" for p in prompts))
    rows = serve.main([
        "--checkpoint_dir", ckpt, "--prompts_file", str(pfile), "--output_file", str(ofile),
        "--max_new_tokens", str(NEW), "--temperature", "0", "--device", "cpu",
    ])
    lens = np.array([len(p) for p in prompts], np.int32)
    padded = np.zeros((3, lens.max()), np.int32)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = p
    want = np.asarray(jgen.generate_ragged(
        model, variables, jnp.asarray(padded), jnp.asarray(lens), jax.random.PRNGKey(0),
        max_new_tokens=NEW, temperature=0.0,
    ))
    assert rows == [want[i, : n + NEW].tolist() for i, n in enumerate(lens)]
    lines = [json.loads(ln) for ln in ofile.read_text().splitlines()]
    assert [ln["output_ids"] for ln in lines] == rows
    assert [ln["prompt_ids"] for ln in lines] == prompts
    assert "batch: 3 prompts" in capsys.readouterr().out


def test_serve_random_init_samples_in_vocab(capsys):
    """Seeded random weights at the flags' shape, sampled with top-k and
    top-p: the same seed gives the same tokens."""
    argv = ["--d_model", "32", "--num_layers", "1", "--num_heads", "2", "--num_experts", "4",
            "--window_size", "16", "--seq_len", "64", "--prompt_ids", "5,17,200",
            "--max_new_tokens", "5", "--temperature", "0.8", "--top_k", "50",
            "--top_p", "0.95", "--device", "cpu"]
    a, b = serve.main(argv), serve.main(argv)
    assert a == b and a[0][:3] == [5, 17, 200] and len(a[0]) == 8
    assert all(0 <= t < 50257 for t in a[0])
    assert "random init" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (["--tensor_parallelism", "2"], "2 devices|of 1 ranks|!= 1"),
    (["--prompt", "hello"], "--prompt"),
    (["--text_prompts"], "text_prompts"),
])
def test_serve_unported_flags_raise(flags, match):
    """The flags still refused. --tensor_parallelism is ported: it serves
    under torchrun (tests/test_torch_parallel_cli_tp.py), and a lone
    process refuses it for want of ranks, as the JAX CLI does for want of
    devices. --beam_size, --draft_checkpoint_dir, --quantize and
    --prefix_ids run: tests/test_torch_{beam,speculative,quant,prefix}.py;
    --use_ema and --lora_base_dir: tests/test_torch_{ema,lora,resume}.py."""
    error = ValueError if flags[0] == "--tensor_parallelism" else NotImplementedError
    with pytest.raises(error, match=match):
        serve.main(flags + ["--device", "cpu", "--d_model", "32", "--num_layers", "1",
                            "--num_heads", "2", "--window_size", "16"])


def test_serve_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        serve.main(["--prompt_ids", "1,2"])


def test_serve_moe_capacity_names_training_slice(tmp_path, capsys):
    """A checkpoint with capacity dispatch is served (its training slice
    is ported): the same greedy tokens as the JAX package's
    ``generate_cached``; expert-parallel dispatch needs a mesh, which
    serving has not, and is refused as the JAX package refuses it."""
    ckpt = str(tmp_path / "ckpt")
    cfg = tiny_config(moe_dispatch="capacity")
    model, variables = jax_variables(cfg, seed=9)
    save_model_config(ckpt, cfg, {"step": 3})
    np.savez(f"{ckpt}/params.npz", **interop.flatten(variables))
    prompt = np.random.RandomState(4).randint(1, 256, 24).tolist()
    rows = serve.main([
        "--checkpoint_dir", ckpt, "--prompt_ids", ",".join(map(str, prompt)),
        "--max_new_tokens", str(NEW), "--temperature", "0", "--device", "cpu",
    ])
    want = jgen.generate_cached(model, variables, jnp.asarray([prompt], jnp.int32),
                                jax.random.PRNGKey(0), max_new_tokens=NEW, temperature=0.0)
    assert rows == np.asarray(want).tolist()
    assert "restored step 3" in capsys.readouterr().out
    with pytest.raises(ValueError, match="requires a mesh"):
        serve.main(["--d_model", "32", "--num_layers", "1", "--num_heads", "2",
                    "--moe_dispatch", "ep", "--device", "cpu"])
