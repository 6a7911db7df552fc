"""The brain-map plots (forde_tpu_torch/obs/plots.py), mirroring
tests/test_obs.py's plot tests, and the two loops' ``--plots_dir``:

* the three plots are written, under the JAX package's file names, and a
  1-D assignment vector renders as one row;
* the LM loop and the clip loop with ``--plots_dir`` write the same files
  (names and subdirectories) as the JAX package's loops on the same run
  (a tiny decoder, 2 steps, the MoE slow loop at step 2; a 1 + 1 layer
  dual encoder, 2 steps, the neuron slow loop at step 2, its two plotted
  layers chosen and named as JAX's);
* ``--plots_dir`` where matplotlib cannot be imported raises before the
  first step, naming matplotlib, in both loops.
"""

import os
import sys

import numpy as np
import pytest
import torch

from forde_tpu.obs import plots as jplots
from forde_tpu.train import clip_loop as jclip
from forde_tpu.train import loop as jloop
from forde_tpu_torch.obs import plots
from forde_tpu_torch.train import clip_loop, loop

torch.set_num_threads(1)

LM = ["--use_dummy_data", "--steps_per_epoch", "2", "--batch_size", "2", "--seq_len", "32",
      "--d_model", "32", "--num_layers", "1", "--num_heads", "2", "--num_experts", "4",
      "--window_size", "8", "--slow_loop_interval", "2", "--log_interval", "1"]
CLIP = ["--preset", "custom", "--image_size", "32", "--patch_size", "16", "--tower_layers", "1",
        "--tower_dim", "128", "--embed_dim", "32", "--text_len", "16", "--batch_size", "4",
        "--num_steps", "2", "--use_dummy_data", "--slow_loop_interval", "2",
        "--log_interval", "1", "--forde_lite"]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_plot_artifacts_written(tmp_path):
    out = str(tmp_path / "plots")
    grid = np.array([[0, 1, 2], [1, 1, 0]])
    p1 = plots.plot_brain_scan(grid, epoch=0, step=10, output_dir=out)
    stats = np.random.RandomState(0).rand(12, 2)
    assigns = np.random.RandomState(1).randint(0, 3, 12)
    p2 = plots.plot_feature_space(stats, assigns, 0, 10, out)
    p3 = plots.plot_census(assigns, 0, 10, out, num_clusters=3,
                           labels={0: "Gen", 1: "Pool", 2: "Spec"})
    for p in (p1, p2, p3):
        assert os.path.exists(p) and os.path.getsize(p) > 0
    assert "brain_scan_epoch0_step10.png" in p1
    jout = str(tmp_path / "jax")
    want = [jplots.plot_brain_scan(grid, 0, 10, jout), jplots.plot_feature_space(
        stats, assigns, 0, 10, jout), jplots.plot_census(assigns, 0, 10, jout, num_clusters=3)]
    assert [os.path.basename(p) for p in (p1, p2, p3)] == [os.path.basename(p) for p in want]


def test_plot_brain_scan_1d_assignments(tmp_path):
    p = plots.plot_brain_scan(np.array([0, 1, 2, 1, 0, 2, 1]), 1, 5, str(tmp_path))
    assert os.path.exists(p)
    assert plots.grid_of(np.arange(7)).shape == (1, 7)
    assert plots.grid_of(np.arange(12)).shape == (3, 4)


@pytest.mark.parametrize("which", ["lm", "clip"])
def test_loops_write_the_jax_loops_files(tmp_path, monkeypatch, which):
    monkeypatch.chdir(tmp_path)  # the loops' metrics go to ./runs
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    if which == "lm":
        jloop.train(jloop.build_parser().parse_args(LM + ["--plots_dir", jax_dir]))
        out = loop.main(LM + ["--plots_dir", port_dir, "--device", "cpu"])
        assert [u["skipped"] for u in out["brain_updates"]] == [False]
    else:
        jclip.train(jclip.build_parser().parse_args(CLIP + ["--plots_dir", jax_dir]))
        out = clip_loop.main(CLIP + ["--plots_dir", port_dir, "--device", "cpu"])
        assert [u["skipped"] for u in out["brain_updates"]] == [False]
    want = _files(jax_dir)
    assert want and _files(port_dir) == want
    if which == "clip":
        assert sorted(os.listdir(port_dir)) == ["text_block_0_stateful", "vision_block_0_stateful"]


def test_plot_layers_follow_jax_order():
    names = [f"{t}.blocks.{i}.stateful" for t in ("vision", "text") for i in (0, 1, 2, 10, 11)]
    assert clip_loop.plot_layers(names) == {"text.blocks.0.stateful": "text_block_0_stateful",
                                            "text.blocks.1.stateful": "text_block_1_stateful"}
    assert list(clip_loop.plot_layers(["vision.blocks.2.stateful", "vision.blocks.10.stateful"])
                ) == ["vision.blocks.10.stateful", "vision.blocks.2.stateful"]


@pytest.mark.parametrize("which", ["lm", "clip"])
def test_plots_dir_without_matplotlib_raises_before_the_first_step(tmp_path, monkeypatch, which):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib -> ImportError
    argv = (LM if which == "lm" else CLIP) + ["--device", "cpu", "--plots_dir", "p"]
    main = loop.main if which == "lm" else clip_loop.main
    with pytest.raises(RuntimeError, match="--plots_dir needs matplotlib"):
        main(argv)
    assert not os.path.exists("runs") and not os.path.exists("p")
