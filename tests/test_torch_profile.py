"""``--profile_dir`` in the port's two training loops (obs/profiler.py), on
the CPU: each run writes one ``torch.profiler`` trace that loads as JSON
and holds the step's ops (the LM step's cross-entropy, the contrastive
step's log-softmax, the optimizer's foreach updates); a run without the
flag writes none.
"""

import glob
import json
import os

import pytest
import torch

from forde_tpu_torch.train import clip_loop, loop

torch.set_num_threads(1)

LM = ["--device", "cpu", "--use_dummy_data", "--steps_per_epoch", "2", "--batch_size", "2",
      "--seq_len", "32", "--d_model", "32", "--num_layers", "1", "--num_heads", "2",
      "--num_experts", "2", "--window_size", "8", "--slow_loop_interval", "0",
      "--log_interval", "1"]
CLIP = ["--device", "cpu", "--preset", "custom", "--image_size", "32", "--patch_size", "16",
        "--tower_layers", "1", "--tower_dim", "128", "--embed_dim", "32", "--text_len", "16",
        "--batch_size", "2", "--num_steps", "2", "--use_dummy_data",
        "--slow_loop_interval", "0", "--log_interval", "1"]


@pytest.mark.parametrize("which,op", [("lm", "aten::cross_entropy_loss"),
                                      ("clip", "aten::log_softmax")])
def test_profile_dir_writes_a_trace_of_the_steps(tmp_path, monkeypatch, capsys, which, op):
    monkeypatch.chdir(tmp_path)
    main, argv = (loop.main, LM) if which == "lm" else (clip_loop.main, CLIP)
    out = main(argv + ["--profile_dir", "prof"])
    traces = glob.glob(os.path.join("prof", "*.pt.trace.json"))
    assert len(traces) == 1 and out["traces"] == traces
    assert "profile trace" in capsys.readouterr().out
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert op in names
    assert any(n and n.startswith("aten::_foreach") for n in names)  # the AdamW update
    assert sum(e.get("name") == op for e in events) >= 2  # both steps
    plain = main(argv)
    assert plain["traces"] == [] and len(glob.glob(os.path.join("prof", "*"))) == 1
