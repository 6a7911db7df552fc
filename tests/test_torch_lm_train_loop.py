"""The port's MoE slow loop, LM data and training CLI
(forde_tpu_torch.brain.{slow_loop,actuation,smoothing,clustering},
data.lm, train.loop) against the JAX package's.

* ``moe_slow_loop_step`` on a small decoder (2 layers, 8 experts in a 2 x 4
  grid) with seeded ``expert_usage`` sums: the GMM starts from the means
  that the JAX package's k-means++ picks with its key (k-means++ draws
  from ``jax.random``, which a ``torch.Generator`` cannot reproduce, as
  tests/test_torch_neuron_slow_loop.py does), then assignments, smoothing,
  diagnostics, router biases and the reset buffers match; with no sensed
  step the update is a no-op.
* ``smooth_assignments_3d`` (exactly, but where two clusters tie: the JAX
  package's fp32 sums of 1/27 weights break a tie by rounding noise, the
  port gives it to the lowest label), ``compute_router_adjustments`` and
  ``collect_moe_stats``.
* The LM datasets: the same numpy batches as the JAX package's.
* ``train.loop`` on the CPU: a few steps with the slow loop and a
  checkpoint that ``serve`` then decodes from; the config derivation of
  the JAX CLI; every refused flag names the slice it waits for (the
  training extras' second part or multi-device; the extras of
  tests/test_torch_{ema,grad_accum,resume,lora,distill}.py run); with no
  GPU the CLI raises.

Tolerance: fp32 diagnostics and biases within 1e-5 (the same fp32
arithmetic in another order); assignments, counts and batches exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.brain import actuation as jact
from forde_tpu.brain import slow_loop as jloop
from forde_tpu.brain.smoothing import smooth_assignments_3d as jax_smooth_3d
from forde_tpu.core import config as jcfg
from forde_tpu.data import lm as jlm
from forde_tpu.ops import gmm as jgmm
from forde_tpu.train import loop as jtrain
from forde_tpu_torch import interop, serve
from forde_tpu_torch.brain import actuation as tact
from forde_tpu_torch.brain import slow_loop as tloop
from forde_tpu_torch.brain.clustering import cluster_experts
from forde_tpu_torch.brain.smoothing import mode_counts_3d, smooth_assignments_3d
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.data import lm as tlm
from forde_tpu_torch.train import loop

from test_torch_decoder_lm import jax_variables, port_model, tiny_config

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the MoE slow loop
# ---------------------------------------------------------------------------


def _sensed(cfg, steps, seed):
    """The JAX variables of ``cfg`` with ``steps`` seeded router-probability
    means summed into every layer's ``expert_usage``."""
    _, variables = jax_variables(cfg)
    rng = np.random.RandomState(seed)
    stats = {}
    for i in range(cfg.num_layers):
        probs = rng.dirichlet(np.full(cfg.num_experts, 2.0), size=steps).astype(np.float32)
        stats[f"layer_{i}"] = {"moe": {
            "expert_usage": probs.sum(0) if steps else np.zeros(cfg.num_experts, np.float32),
            "step_count": np.int32(steps),
        }}
    return {"params": variables["params"], "stats_buffer": stats}


def _jax_init_means(variables, cfg, key):
    """The GMM's initial means in the JAX slow loop: k-means++ over the
    (E, 2) features with the key it splits off for clustering."""
    usage, count = jloop.collect_moe_stats(variables, cfg.num_layers, cfg.num_experts)
    usage = usage / jnp.maximum(count, 1).astype(jnp.float32)
    features = jnp.stack([usage.mean(0), usage.var(0)], axis=-1)
    _, cluster_key = jax.random.split(key)
    return np.asarray(jgmm._kmeans_pp_init(features, 3, cluster_key))


def _tied(raw):
    """(E,) bool: the cells of the (1, gh, gw) grid of ``raw`` assignments
    whose mode filter ties (two clusters share the top count). There the
    JAX package's fp32 sums of 1/27 weights pick either by rounding noise,
    and the port the lowest label; elsewhere the two must agree."""
    grid = torch.from_numpy(np.asarray(raw, np.int64).reshape(1, 2, -1))
    counts = mode_counts_3d(grid)
    return ((counts == counts.max(0).values).sum(0) > 1).reshape(-1).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_slow_loop_matches_jax(seed):
    cfg = tiny_config(num_experts=8)
    variables = _sensed(cfg, steps=3, seed=seed)
    key = jax.random.PRNGKey(seed)
    new_params, new_mutable, want = jloop.moe_slow_loop_step(
        variables["params"], {"stats_buffer": variables["stats_buffer"]}, cfg, key
    )
    model = port_model(cfg, variables)
    t_cfg = model.config
    init = torch.from_numpy(_jax_init_means(variables, cfg, key).copy())
    got = tloop.moe_slow_loop_step(model, t_cfg, init_means=init)
    for k in ("step_count", "updates_count", "skipped"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("expert_usage", "load_imbalance", "routing_entropy", "cluster_features",
              "gmm_weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    assert int(got["updates_count"]) == cfg.num_layers
    # The GMM's own assignments agree (the features and the start do), so
    # the smoothing sees the same grid; a tied cell may differ.
    init = torch.from_numpy(_jax_init_means(variables, cfg, key).copy())
    raw, _ = cluster_experts(got["cluster_features"], 3, init_means=init)
    tied = _tied(raw.numpy())
    same = got["assignments"].numpy() == np.asarray(want["assignments"])
    assert same[~tied].all(), (got["assignments"], want["assignments"], tied)
    np.testing.assert_allclose(got["adjustments"].numpy()[same],
                               np.asarray(want["adjustments"])[same], **TOL)
    port = interop.state_dict_to_flax(model.state_dict())
    want_params = interop.flatten(jax.device_get(new_params))
    for k, v in interop.flatten(port["params"]).items():
        if "router_linear/bias" in k:  # experts whose smoothed label agrees
            v, w = v[same], np.asarray(want_params[k])[same]
        else:
            w = np.asarray(want_params[k])
        np.testing.assert_allclose(v, w, err_msg=k, **TOL)
    for k, v in interop.flatten(port["stats_buffer"]).items():
        assert not v.any(), k  # reset
    assert not any(np.asarray(v).any() for v in
                   interop.flatten(jax.device_get(new_mutable["stats_buffer"])).values())


def test_moe_slow_loop_without_sensed_steps_is_a_no_op(capsys):
    cfg = tiny_config(num_experts=8)
    variables = _sensed(cfg, steps=0, seed=3)
    model = port_model(cfg, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    diag = tloop.moe_slow_loop_step(model, model.config, torch.Generator().manual_seed(0),
                                    verbose=True)
    assert bool(diag["skipped"]) and not diag["adjustments"].any()
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert "no-op" in capsys.readouterr().out


@pytest.mark.parametrize("shape", [(1, 2, 4), (1, 4, 4), (3, 3, 3), (2, 5, 7), (4, 2, 2),
                                   (1, 1, 8)])
def test_smooth_assignments_3d_matches_jax(shape):
    """Equal at every cell whose top count is unique; at a tie the port
    takes the lowest tied label and JAX one of the tied labels."""
    grid = np.random.RandomState(sum(shape)).randint(0, 3, shape).astype(np.int32)
    want = np.asarray(jax_smooth_3d(jnp.asarray(grid), kernel_size=3, num_clusters=3))
    got = smooth_assignments_3d(torch.from_numpy(grid), kernel_size=3, num_clusters=3).numpy()
    counts = mode_counts_3d(torch.from_numpy(grid)).numpy()
    top = counts == counts.max(0)
    tied = top.sum(0) > 1
    np.testing.assert_array_equal(got[~tied], want[~tied])
    np.testing.assert_array_equal(got[tied], top.argmax(0)[tied])
    assert np.take_along_axis(top, want[None], 0).all()


def test_router_adjustments_and_stats_match_jax():
    rng = np.random.RandomState(5)
    assignments = rng.randint(0, 3, 8).astype(np.int32)
    usage = rng.dirichlet(np.ones(8)).astype(np.float32)
    want = jact.compute_router_adjustments(jnp.asarray(assignments), jnp.asarray(usage))
    got = tact.compute_router_adjustments(torch.from_numpy(assignments), torch.from_numpy(usage))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cfg = tiny_config(num_experts=8)
    variables = _sensed(cfg, steps=4, seed=6)
    want_usage, want_count = jloop.collect_moe_stats(variables, cfg.num_layers, cfg.num_experts)
    got_usage, got_count = tloop.collect_moe_stats(port_model(cfg, variables), cfg.num_layers,
                                                   cfg.num_experts)
    np.testing.assert_array_equal(got_usage.numpy(), np.asarray(want_usage))
    assert int(got_count) == int(want_count) == 4


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a["input_ids"].dtype == b["input_ids"].dtype
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])


def test_lm_datasets_match_jax(tmp_path):
    _same_batches(tlm.create_dummy_dataset(2, 16, 500, num_batches=3),
                  jlm.create_dummy_dataset(2, 16, 500, num_batches=3))
    _same_batches(tlm.DummyBatchedDataset(2, 16, 500, num_batches=2),
                  jlm.DummyBatchedDataset(2, 16, 500, num_batches=2))
    t = tlm.create_markov_dataset(3, 24, 1000, num_batches=3, active_vocab=40, p=0.8, seed=7)
    j = jlm.create_markov_dataset(3, 24, 1000, num_batches=3, active_vocab=40, p=0.8, seed=7)
    _same_batches(t, j)
    assert t.entropy_floor() == j.entropy_floor()
    text = tmp_path / "corpus.txt"
    text.write_bytes(bytes(range(256)) * 3)
    ids = tmp_path / "ids.npy"
    np.save(ids, np.random.RandomState(8).randint(0, 700, 500))
    for path, batch, seq in ((text, 4, 32), (ids, 3, 20), (text, 64, 128)):  # the last: tiny corpus
        _same_batches(tlm.create_text_file_dataset(str(path), batch, seq, num_batches=5, seed=9),
                      jlm.create_text_file_dataset(str(path), batch, seq, num_batches=5, seed=9))
    with pytest.raises(NotImplementedError, match="tokenizer"):
        tlm.TextFileDataset(str(text), 2, 16, tokenizer="gpt2")


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

TINY = ["--d_model", "64", "--num_layers", "2", "--num_heads", "2", "--num_experts", "8",
        "--window_size", "16", "--seq_len", "64", "--batch_size", "2"]


def test_train_loop_cli_trains_and_serves(tmp_path, monkeypatch, capsys):
    """Four steps with the slow loop every 2nd and a checkpoint, on the
    CPU; then the serve CLI decodes from that checkpoint."""
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    out = loop.main(TINY + ["--use_markov_data", "--steps_per_epoch", "4", "--log_interval", "2",
                            "--slow_loop_interval", "2", "--checkpoint_dir", ckpt,
                            "--device", "cpu", "--experiment_name", "t"])
    assert out["step"] == 4 and np.isfinite(out["final_metrics"]["loss/total"])
    assert [u["step"] for u in out["brain_updates"]] == [2, 4]
    assert all(not u["skipped"] and u["updates_count"] == 2 for u in out["brain_updates"])
    printed = capsys.readouterr().out
    assert "MoE Slow Loop - Epoch 0, Step 4" in printed and "checkpoint (step 4)" in printed
    (run_dir,) = (tmp_path / "runs").iterdir()
    tags = {ln.split('"tag": "')[1].split('"')[0] for ln in (run_dir / "metrics.jsonl").open()}
    assert {"Loss/total", "Loss/lm", "Training/grad_norm", "SlowLoop/latency_ms",
            "SlowLoop/routing_entropy", "Throughput/tokens_per_sec_per_chip"} <= tags
    # the buffers the checkpoint holds are those the last slow loop reset
    rows = serve.main(["--checkpoint_dir", ckpt, "--prompt_ids", "5,17,200",
                       "--max_new_tokens", "4", "--temperature", "0", "--device", "cpu"])
    assert rows[0][:3] == [5, 17, 200] and len(rows[0]) == 7
    assert "restored step 4" in capsys.readouterr().out


def test_config_from_args_matches_jax():
    argv = TINY + ["--num_streams", "3", "--bf16", "--moe_dispatch", "capacity", "--no_mhc"]
    want = jtrain.config_from_args(jtrain.build_parser().parse_args(argv))
    got = loop.config_from_args(loop.build_parser().parse_args(argv))
    assert tcfg.config_to_dict(got) == jcfg.config_to_dict(want)
    assert serve.config_from_args is loop.config_from_args


@pytest.mark.parametrize("flags,refusal", [
    (["--moe_dispatch", "ep"], "requires --expert_parallelism > 1"),
    (["--expert_parallelism", "2"], "of 1 ranks"),
    (["--context_parallelism", "2"], "of 1 ranks"),
    (["--tensor_parallelism", "2"], "of 1 ranks"),
    (["--pipeline_parallelism", "2"], "--pipeline_parallelism requires --scan_layers"),
    (["--param_sharding", "fsdp"], None),
    (["--data_file", "x.txt", "--tokenizer", "gpt2"], "tokenizer"),
])
def test_unported_flags_name_their_slice(flags, refusal):
    """The gpt2 tokenizer is refused and names what it waits for (a
    tokenizer). The multi-device flags are ported
    (tests/test_torch_parallel_cli.py, tests/test_torch_parallel_cli_tp.py):
    a lone process refuses what the JAX loop refuses there, ep for want of
    an expert axis, ``--pipeline_parallelism`` without ``--scan_layers``
    with the JAX loop's message, and the other axes for want of ranks;
    ``--param_sharding fsdp`` over a data axis of 1 trains as replicated."""
    argv = TINY + ["--use_dummy_data", "--device", "cpu"] + flags
    if refusal is None:
        out = loop.main(argv + ["--steps_per_epoch", "1", "--slow_loop_interval", "0"])
        assert out["step"] == 1 and np.isfinite(out["final_metrics"]["loss/total"])
        return
    if flags[0] == "--data_file":
        with pytest.raises(NotImplementedError, match=refusal):
            loop.main(argv)
        return
    with pytest.raises(ValueError, match=refusal):
        loop.main(argv)


def test_plots_dir_defaults_to_none():
    """The loop writes no plots unless asked (the JAX loop's default is
    "plots")."""
    assert loop.build_parser().parse_args(TINY).plots_dir is None


def test_streamed_corpus_is_refused():
    with pytest.raises(NotImplementedError, match="streamed corpus"):
        loop.main(TINY + ["--device", "cpu"])


def test_train_loop_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        loop.main(TINY + ["--use_dummy_data"])
