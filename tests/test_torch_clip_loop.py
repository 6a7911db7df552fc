"""The port's training CLI (forde_tpu_torch.train.clip_loop) on the CPU:
the tiny preset (Forde-lite) and a small custom GMM model take a few
steps with the sensing stride, the slow loop fires and resets the
statistics, the loss is finite, and the written checkpoint serves through
the port's ``embed.main``."""

import numpy as np
import pytest
import torch

from forde_tpu_torch import embed, kernels
from forde_tpu_torch.train import clip_loop

torch.set_num_threads(1)


def test_tiny_preset_trains_senses_updates_and_serves(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)  # metrics go to ./runs
    ckpt = str(tmp_path / "ckpt")
    kernels.reset_launches()
    out = clip_loop.main([
        "--device", "cpu", "--preset", "tiny", "--use_dummy_data", "--batch_size", "2",
        "--num_steps", "4", "--log_interval", "2", "--sense_interval", "2",
        "--slow_loop_interval", "2", "--warmup_steps", "1", "--checkpoint_dir", ckpt,
    ])
    assert out["step"] == 4 and np.isfinite(out["final_metrics"]["loss/contrastive"])
    assert sum(kernels.launches.values()) == 0  # CPU tensors take the plain versions
    updates = out["brain_updates"]
    assert [u["step"] for u in updates] == [2, 4]
    n_layers = 12 + 2  # vit_tiny: 12 vision + 2 text StatefulLayers
    for u in updates:
        assert not u["skipped"]
        assert u["grad_stats_abs_sum_before"] > 0 and u["grad_stats_abs_sum_after"] == 0
        # one sensed step (of the two) per layer since the last update
        assert u["sensed_steps_before"] == n_layers and u["sensed_steps_after"] == 0
    assert "mode=Forde-lite" in capsys.readouterr().out
    assert (tmp_path / "runs").is_dir()

    embed.main(["--checkpoint_dir", ckpt, "--text_ids", "12,99,407;7,5",
                "--device", "cpu", "--out", str(tmp_path / "emb")])
    text = capsys.readouterr().out
    assert "restored step 4" in text and "2 text embeddings" in text
    emb = np.load(tmp_path / "emb_text.npy")
    assert emb.shape == (2, 192) and np.isfinite(emb).all()


def test_custom_gmm_run_with_bf16_moments(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = clip_loop.main([
        "--device", "cpu", "--preset", "custom", "--tower_layers", "2", "--tower_dim", "128",
        "--image_size", "32", "--text_len", "16", "--gmm", "--use_dummy_data",
        "--dummy_pool", "2", "--batch_size", "4", "--num_steps", "3",
        "--log_interval", "1", "--slow_loop_interval", "3", "--moment_dtype", "bfloat16",
        "--lr_schedule", "cosine",
    ])
    printed = capsys.readouterr().out
    assert "cosine decay over 3 steps" in printed and "mode=GMM" in printed
    assert len(out["brain_updates"]) == 1 and not out["brain_updates"][0]["skipped"]
    assert all(m.dtype == torch.bfloat16 for m in out["state"].optimizer.mu)


@pytest.mark.parametrize("flag", ["--tensor_parallelism", "--ema_decay", "--resume",
                                  "--plots_dir"])
def test_unported_flags_are_not_accepted(flag):
    with pytest.raises(SystemExit):
        clip_loop.build_parser().parse_args([flag, "1"])


def test_cuda_is_the_default_device():
    assert clip_loop.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU is visible"):
            clip_loop.main(["--use_dummy_data", "--num_steps", "1"])
