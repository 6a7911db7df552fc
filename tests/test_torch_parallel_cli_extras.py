"""The LM loop's training extras under data parallelism (``torchrun
--standalone --nproc_per_node 4 ... --device cpu``, data 4) against one
process: ``--grad_accum 2`` (each rank's microbatches are its rows of the
global microbatches), ``--ema_decay``, LoRA over a checkpoint (the
adapters' gradients reduced as any other) and distillation from it (the
teacher on the same mesh; CE and KL as shares of the global means). Held
as in test_torch_parallel_cli.py: the final loss within 1e-5 relative and
the checkpoint by ``assert_same_checkpoint``.

And the JAX loop's refusals of flag combinations: the port's loop raises
the same error, word for word, for the same flags.
"""

import os

import jax
import pytest

from forde_tpu.train import loop as jloop
from forde_tpu_torch.obs.metrics import REFERENCE_TAGS
from forde_tpu_torch.train import loop

from test_torch_parallel_cli import LM, LR, assert_same_checkpoint, final_metric, one_process
from test_torch_parallel_cli import torchrun

TAG = REFERENCE_TAGS.get("loss/total", "loss/total")


@pytest.fixture
def base(tmp_path_factory, monkeypatch):
    """A one-step checkpoint to warm-start and adapt."""
    cwd = tmp_path_factory.mktemp("base")
    one_process(loop.main, cwd, LM + ["--steps_per_epoch", "1", "--checkpoint_dir", "ck"],
                monkeypatch)
    return os.path.join(cwd, "ck")


@pytest.mark.parametrize("extra", ["grad_accum", "ema", "lora", "distill"])
def test_data_parallel_training_extras(extra, base, tmp_path, monkeypatch):
    flags = {
        "grad_accum": ["--batch_size", "8", "--grad_accum", "2"],
        "ema": ["--ema_decay", "0.9"],
        "lora": ["--init_from", base, "--lora_rank", "4", "--slow_loop_interval", "0"],
        "distill": ["--distill_from", base, "--num_layers", "1"],
    }[extra]
    argv = LM + ["--steps_per_epoch", "3"] + flags
    out = torchrun(tmp_path, "forde_tpu_torch.train.loop",
                   argv + ["--checkpoint_dir", "four", "--experiment_name", "four"])
    assert "mesh: {'data': 4" in out
    one_process(loop.main, tmp_path, argv + ["--checkpoint_dir", "one",
                                             "--experiment_name", "one"], monkeypatch)
    four, one = final_metric(tmp_path, "four", TAG), final_metric(tmp_path, "one", TAG)
    assert abs(four - one) <= 1e-5 * abs(one)
    assert_same_checkpoint(str(tmp_path / "one"), str(tmp_path / "four"), LR, 3)


REFUSED = {
    "lora-context": ["--lora_rank", "4", "--slow_loop_interval", "0",
                     "--context_parallelism", "2"],
    "lora-ep": ["--lora_rank", "4", "--slow_loop_interval", "0", "--moe_dispatch", "ep",
                "--expert_parallelism", "2"],
    "lora-grad-accum": ["--lora_rank", "4", "--slow_loop_interval", "0", "--grad_accum", "2"],
    "ep-without-expert-axis": ["--moe_dispatch", "ep"],
    "window-over-shards": ["--window_size", "32", "--context_parallelism", "4"],
    "seq-not-divisible": ["--seq_len", "66", "--context_parallelism", "4"],
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_flag_errors_match_jax(case, base):
    argv = [a for a in LM if a not in ("--device", "cpu")] + REFUSED[case]
    if case.startswith("lora"):
        argv += ["--init_from", base]
    with pytest.raises(ValueError) as want:
        jloop.train(jloop.build_parser().parse_args(argv))
    with pytest.raises(ValueError) as got:
        loop.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert jax.device_count() == 8  # the JAX loop refused before touching a mesh
