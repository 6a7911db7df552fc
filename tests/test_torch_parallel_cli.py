"""The training CLIs under ``torchrun --standalone --nproc_per_node 4 ...
--device cpu`` (four gloo processes) against one process of the same CLI:
the decoder LM loop at (data 2, context 2) and at (data 2, expert 2) with
ep dispatch (held against one process's capacity dispatch: 4 experts
top-2 at the default capacity factor 2 drop no token), the dual encoder's
loop at (data 4), and ``--resume`` from one process to four and back.

Each run is held to the other by its final loss (within 1e-5 relative,
from ``runs/*/metrics.jsonl``) and its checkpoint (``assert_same_checkpoint``:
every array within 1e-4 relative plus 1e-4 of its largest value, the
tolerance of the one-step parity tests (test_torch_lm_train.py): gradients
summed over ranks round in another order, and Adam's moments carry that
through a few steps; a moment also within 1e-6 of the largest anywhere, as
there; a parameter also within 1% of lr a step: Adam's update
m^ / sqrt(v^) of a step whose gradients nearly cancel, g2 ~ -g1, carries
their rounding at up to a few hundred times its size, which the final
moments no longer show (the LoRA adapters, 0 at the start, show 0.3%);
where
Adam's first moment is at the level of rounding noise, at most 1e-5 of the
largest anywhere, Adam's m / sqrt(v) turns noise into whole steps, and an
element may then differ by 2 lr a step, its moments by the noise's size).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from forde_tpu_torch.obs.metrics import REFERENCE_TAGS
from forde_tpu_torch.train import clip_loop, loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 3e-4  # the LM loop's default
LM = ["--device", "cpu", "--d_model", "64", "--num_layers", "2", "--num_heads", "2",
      "--window_size", "16", "--seq_len", "64", "--batch_size", "4", "--num_experts", "4",
      "--use_markov_data", "--slow_loop_interval", "2", "--log_interval", "1"]
CLIP = ["--device", "cpu", "--preset", "custom", "--tower_dim", "128", "--tower_layers", "1",
        "--image_size", "32", "--patch_size", "16", "--embed_dim", "32", "--text_len", "16",
        "--batch_size", "8", "--use_dummy_data", "--sense_interval", "2",
        "--slow_loop_interval", "2", "--log_interval", "1"]


def torchrun(cwd, module, argv, nproc=4):
    """Run ``module``'s CLI under torchrun in ``cwd``; returns its stdout."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m", module, *argv]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    done = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    return done.stdout


def final_metric(cwd, experiment, tag):
    (path,) = glob.glob(os.path.join(cwd, "runs", f"{experiment}_*", "metrics.jsonl"))
    rows = [json.loads(line) for line in open(path)]
    return [r["value"] for r in rows if r["tag"] == tag][-1]


def assert_same_checkpoint(a, b, lr, steps, skip=()):
    pa, pb = np.load(os.path.join(a, "params.npz")), np.load(os.path.join(b, "params.npz"))
    oa, ob = np.load(os.path.join(a, "opt_state.npz")), np.load(os.path.join(b, "opt_state.npz"))
    assert sorted(pa) == sorted(pb) and sorted(oa) == sorted(ob)
    assert int(oa["step"]) == int(ob["step"]) == steps
    top = {m: max(np.abs(oa[k]).max() for k in oa if k.startswith(m)) for m in ("mu/", "nu/")}
    noise = 1e-5 * top["mu/"]
    for store, name in ((pa, "params"), (oa, "opt_state")):
        other = pb if store is pa else ob
        for k in store:
            if k in skip or store[k].dtype.kind not in "f":
                np.testing.assert_array_equal(store[k], other[k], err_msg=k)
                continue
            want, got = store[k].astype(np.float64), other[k].astype(np.float64)
            tol = 1e-4 * np.abs(want) + 1e-4 * np.abs(want).max()
            path = k.split("/", 1)[1] if k.startswith(("params/", "ema_params/", "mu/", "nu/")) \
                else None
            mu = oa.get(f"mu/{path}") if path is not None else None
            if mu is not None and k.startswith(("params/", "ema_params/")):
                tol = np.where(np.abs(mu) <= noise, 2 * lr * steps, tol + 0.01 * lr * steps)
            elif mu is not None:  # a moment: 1e-6 of the largest anywhere as a floor
                tol = tol + 1e-6 * top[k[:3]]
                # and the moments of noise: |g| <= |m| / 0.1 a step
                bound = 2 * noise if k.startswith("mu/") else steps * (10 * noise) ** 2
                tol = np.where(np.abs(mu) <= noise, np.maximum(tol, bound), tol)
            bad = np.abs(got - want) > tol
            assert not bad.any(), f"{name} {k}: max |d| {np.abs(got - want).max():.3g}"


def one_process(main, cwd, argv, monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(cwd)
    return main(argv)


@pytest.mark.parametrize("mesh_flags,single_flags", [
    (["--context_parallelism", "2"], []),
    (["--expert_parallelism", "2", "--moe_dispatch", "ep"], ["--moe_dispatch", "capacity"]),
], ids=["data2-context2", "data2-expert2-ep"])
def test_lm_loop_under_torchrun_equals_one_process(mesh_flags, single_flags, tmp_path,
                                                   monkeypatch):
    steps = ["--steps_per_epoch", "3"]
    out = torchrun(tmp_path, "forde_tpu_torch.train.loop",
                   LM + steps + mesh_flags + ["--checkpoint_dir", "four", "--experiment_name",
                                              "four"])
    assert "process group: gloo over 4 rank(s)" in out and "mesh: " in out
    assert out.count("step 3:") == 1  # rank 0 alone logs
    one_process(loop.main, tmp_path, LM + steps + single_flags + [
        "--checkpoint_dir", "one", "--experiment_name", "one"], monkeypatch)
    tag = REFERENCE_TAGS.get("loss/total", "loss/total")
    four, one = final_metric(tmp_path, "four", tag), final_metric(tmp_path, "one", tag)
    assert abs(four - one) <= 1e-5 * abs(one)
    assert_same_checkpoint(str(tmp_path / "one"), str(tmp_path / "four"), LR, 3)


def test_clip_loop_data_parallel_equals_one_process(tmp_path, monkeypatch):
    steps = ["--num_steps", "4"]
    out = torchrun(tmp_path, "forde_tpu_torch.train.clip_loop",
                   CLIP + steps + ["--checkpoint_dir", "four", "--experiment_name", "four"])
    assert "mesh: {'data': 4" in out
    one_process(clip_loop.main, tmp_path, CLIP + steps + [
        "--checkpoint_dir", "one", "--experiment_name", "one"], monkeypatch)
    four = final_metric(tmp_path, "four", "loss/contrastive")
    one = final_metric(tmp_path, "one", "loss/contrastive")
    assert abs(four - one) <= 1e-5 * abs(one)
    assert_same_checkpoint(str(tmp_path / "one"), str(tmp_path / "four"), 1e-4, 4)


@pytest.mark.parametrize("first", ["one", "four"])
def test_resume_across_world_sizes(first, tmp_path, monkeypatch):
    """Two steps on one world size, two more resumed on the other (the
    expert banks gathered into the checkpoint, and sliced again on
    restore), against four steps on one process the same way."""
    ep = ["--expert_parallelism", "2", "--moe_dispatch", "ep"]
    cap = ["--moe_dispatch", "capacity"]

    def run(where, steps, ckpt, name, resume):
        argv = LM + ["--steps_per_epoch", str(steps), "--checkpoint_dir", ckpt,
                     "--experiment_name", name] + (["--resume"] if resume else [])
        if where == "four":
            torchrun(tmp_path, "forde_tpu_torch.train.loop", argv + ep)
        else:
            one_process(loop.main, tmp_path, argv + cap, monkeypatch)

    run("one", 2, "ref", "ref_a", False)
    run("one", 4, "ref", "ref_b", True)
    second = "four" if first == "one" else "one"
    run(first, 2, "mixed", "mixed_a", False)
    run(second, 4, "mixed", "mixed_b", True)
    assert_same_checkpoint(str(tmp_path / "ref"), str(tmp_path / "mixed"), LR, 4)
