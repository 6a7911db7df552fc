"""Tensor and pipeline parallelism and FSDP through the CLIs, under ``torchrun
--standalone --nproc_per_node 4 ... --device cpu`` (four gloo processes),
against one process of the same CLI (test_torch_parallel_cli.py's harness
and tolerances):

* the LM loop at ``--tensor_parallelism 2`` (data 2, model 2) and at
  ``--param_sharding fsdp`` (data 4): the final loss within 1e-5 relative
  and the checkpoint (written whole, in the JAX package's layout) against
  one process's;
* a checkpoint saved under (data 2, model 2) with fsdp resumed on one
  process, and one process's resumed under that layout, against four
  steps on one process;
* ``--pipeline_parallelism 2 --scan_layers`` (data 2, pipe 2, 4
  microbatches): the LM loss and the checkpoint against one process with
  the aux weight 0, since the GPipe aux loss is the mean of the data
  shards' microbatch losses, not the batch's (the JAX package's semantics,
  held against JAX in test_torch_pipeline.py);
* the dual encoder's loop at ``--tensor_parallelism 2 --param_sharding
  fsdp --fuse_steps 2``;
* serve ``--tensor_parallelism 2`` (2 processes): the greedy tokens exactly;
* the compositions the JAX loop refuses, refused with the same flags named.
"""

import numpy as np
import pytest

from forde_tpu_torch import serve
from forde_tpu_torch.obs.metrics import REFERENCE_TAGS
from forde_tpu_torch.train import clip_loop, loop

from test_torch_parallel_cli import (
    CLIP, LM, LR, assert_same_checkpoint, final_metric, one_process, torchrun,
)

TAG = REFERENCE_TAGS.get("loss/total", "loss/total")
STEPS = ["--steps_per_epoch", "4", "--batch_size", "8", "--moe_dispatch", "capacity"]
TP_FSDP = ["--tensor_parallelism", "2", "--param_sharding", "fsdp"]


def _lm(tmp_path, monkeypatch, where, name, extra):
    argv = LM + STEPS + ["--checkpoint_dir", name, "--experiment_name", name] + extra
    if where == "four":
        return torchrun(tmp_path, "forde_tpu_torch.train.loop", argv)
    return one_process(loop.main, tmp_path, argv, monkeypatch)


def test_lm_loop_tp_fsdp_and_resume_across_layouts(tmp_path, monkeypatch):
    _lm(tmp_path, monkeypatch, "one", "one", [])
    for name, flags, mesh in (("tp", ["--tensor_parallelism", "2"], "'data': 2"),
                              ("fsdp", ["--param_sharding", "fsdp"], "'data': 4")):
        out = _lm(tmp_path, monkeypatch, "four", name, flags)
        assert f"mesh: {{{mesh}" in out
        got, want = final_metric(tmp_path, name, TAG), final_metric(tmp_path, "one", TAG)
        assert abs(got - want) <= 1e-5 * abs(want), name
        assert_same_checkpoint(str(tmp_path / "one"), str(tmp_path / name), LR, 4)
    # two steps under one layout, two more resumed under the other (a resumed
    # run's data starts again from the top), against one process the same way
    half = ["--steps_per_epoch", "2"]
    for first, second, name in (("one", "one", "ref"), ("four", "one", "mixed_a"),
                                ("one", "four", "mixed_b")):
        _lm(tmp_path, monkeypatch, first, name, (TP_FSDP if first == "four" else []) + half)
        _lm(tmp_path, monkeypatch, second, name,
            (TP_FSDP if second == "four" else []) + ["--resume"])
        if name != "ref":
            assert_same_checkpoint(str(tmp_path / "ref"), str(tmp_path / name), LR, 4)


def test_lm_loop_pipeline_equals_one_process(tmp_path, monkeypatch):
    flags = ["--scan_layers", "--aux_loss_weight", "0"]
    out = _lm(tmp_path, monkeypatch, "four", "pp", flags + ["--pipeline_parallelism", "2"])
    assert "mesh: {'data': 2, 'expert': 1, 'context': 1, 'model': 1, 'pipe': 2}" in out
    _lm(tmp_path, monkeypatch, "one", "one", flags)
    for tag in (TAG, REFERENCE_TAGS.get("loss/lm", "loss/lm")):
        got, want = final_metric(tmp_path, "pp", tag), final_metric(tmp_path, "one", tag)
        assert abs(got - want) <= 1e-5 * abs(want), tag
    assert_same_checkpoint(str(tmp_path / "one"), str(tmp_path / "pp"), LR, 4)


def test_clip_loop_tp_fsdp_fused_equals_one_process(tmp_path, monkeypatch):
    argv = CLIP + ["--num_steps", "4", "--fuse_steps", "2"]
    out = torchrun(tmp_path, "forde_tpu_torch.train.clip_loop",
                   argv + TP_FSDP + ["--checkpoint_dir", "four", "--experiment_name", "four"])
    assert "mesh: {'data': 2, 'expert': 1, 'context': 1, 'model': 2" in out
    one_process(clip_loop.main, tmp_path, argv + [
        "--checkpoint_dir", "one", "--experiment_name", "one"], monkeypatch)
    four = final_metric(tmp_path, "four", "loss/contrastive")
    one = final_metric(tmp_path, "one", "loss/contrastive")
    assert abs(four - one) <= 1e-5 * abs(one)
    assert_same_checkpoint(str(tmp_path / "one"), str(tmp_path / "four"), 1e-4, 4)


def test_serve_tensor_parallel_tokens_equal_one_process(tmp_path, monkeypatch):
    argv = ["--device", "cpu", "--d_model", "64", "--num_layers", "2", "--num_heads", "2",
            "--window_size", "16", "--num_experts", "4", "--prompt_ids", "5,17,200",
            "--temperature", "0", "--max_new_tokens", "8"]
    out = torchrun(tmp_path, "forde_tpu_torch.serve", argv + ["--tensor_parallelism", "2"],
                   nproc=2)
    lines = [ln for ln in out.splitlines() if ln.startswith("token ids:")]
    assert len(lines) == 1  # rank 0 alone prints
    (want,) = one_process(serve.main, tmp_path, argv, monkeypatch)
    assert lines[0] == f"token ids: {want}"


@pytest.mark.parametrize("flags,named", [
    (["--pipeline_parallelism", "2"], "--scan_layers"),
    (["--pipeline_parallelism", "2", "--scan_layers", "--expert_parallelism", "2",
      "--moe_dispatch", "ep"], "--moe_dispatch ep"),
    (["--pipeline_parallelism", "2", "--scan_layers", "--tensor_parallelism", "2"],
     "--tensor_parallelism"),
    (["--pipeline_parallelism", "2", "--scan_layers", "--grad_accum", "2"], "--grad_accum"),
    (["--pipeline_parallelism", "3", "--scan_layers"], "must divide --num_layers"),
    (["--pipeline_parallelism", "2", "--scan_layers", "--pp_microbatches", "3"],
     "must divide --batch_size"),
])
def test_refusals_name_the_flags_the_jax_loop_names(flags, named):
    with pytest.raises(ValueError, match=named):
        loop.main(LM + ["--batch_size", "8"] + flags)


def test_flag_defaults_equal_the_jax_loops():
    from forde_tpu.train import loop as jloop

    port, jax_args = loop.build_parser().parse_args([]), jloop.build_parser().parse_args([])
    for key in ("tensor_parallelism", "pipeline_parallelism", "pp_microbatches",
                "param_sharding"):
        assert getattr(port, key) == getattr(jax_args, key), key
    assert np.isclose(port.aux_loss_weight, jax_args.aux_loss_weight)
