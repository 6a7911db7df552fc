"""The port's benchmark drivers against the reference's (bench.py and
benchmarks/{decoder,serving_bench,quant_decode,decode_scaling}.py).

(a) the seeded inputs are the reference's bit for bit: bench's batch,
    the decoder's tokens, serving's prompts, budgets and Poisson arrivals,
    decode_scaling's prompt;
(b) the timed work is the reference's: with the step and generate
    functions stubbed by recorders on both sides and a clock that counts
    its reads, the sequence of sensed / unsensed steps (fused calls
    unrolled), generate calls and clock reads, and the rate each returns
    and prints, are the reference's for a given preset, steps, stride and k;
(c) ``_pctl`` and every line serving_bench prints per mode are the
    reference's, keys and values, for the same stubbed engines;
(d) each driver runs end to end with ``--device cpu`` at a tiny width and
    its last line is one JSON object with a finite positive value;
(e) each driver without ``--device cpu`` raises when no GPU is visible.

The reference drivers import JAX; they are loaded by path and run with
their engines stubbed (nothing is compiled).
"""

import importlib.util
import json
import math
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def load(rel: str):
    name = "reference_" + rel.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return types.SimpleNamespace(
        bench=load("bench.py"), decoder=load("benchmarks/decoder.py"),
        serving=load("benchmarks/serving_bench.py"),
        quant=load("benchmarks/quant_decode.py"),
        scaling=load("benchmarks/decode_scaling.py"),
    )


@pytest.fixture(scope="module")
def port():
    from forde_tpu_torch import bench
    from forde_tpu_torch.benchmarks import decode_scaling, decoder, quant_decode, serving_bench

    return types.SimpleNamespace(bench=bench, decoder=decoder, serving=serving_bench,
                                 quant=quant_decode, scaling=decode_scaling)


class Recorder:
    """A log of events and a clock whose every read is an event and
    advances it by one second."""

    def __init__(self):
        self.events, self.t, self.arrays = [], 0.0, {}

    def perf_counter(self):
        self.events.append("T")
        self.t += 1.0
        return self.t

    def sleep(self, s):
        self.events.append("sleep")

    def time_module(self):
        return types.SimpleNamespace(perf_counter=self.perf_counter, sleep=self.sleep)

    def keep(self, key, value):
        """The first array seen under ``key``, as numpy."""
        if key not in self.arrays:
            self.arrays[key] = (np.asarray(value) if not isinstance(value, torch.Tensor)
                                else value.numpy())

    def sections(self):
        """(calls before the second-last clock read, calls between the
        last two): the warm-up and the timed section of a run."""
        reads = [i for i, e in enumerate(self.events) if e == "T"]
        lo, hi = reads[-2], reads[-1]
        calls = [e for e in self.events if e != "T"]
        before = [e for e in self.events[:lo] if e != "T"]
        return before, self.events[lo + 1:hi], calls


def fake_jax():
    """The reference's ``jax`` with ``jit`` a no-op, ``lax.scan`` a Python
    loop and one device (the port runs one process on one card)."""

    def scan(f, init, xs, length):
        carry, ys = init, []
        for _ in range(length):
            carry, y = f(carry, None)
            ys.append(y)
        return carry, np.asarray(ys)

    return types.SimpleNamespace(jit=lambda f, **kw: f, lax=types.SimpleNamespace(scan=scan),
                                 random=jax.random, device_count=lambda: 1)


def stub_clip_steps(mp, module, rec):
    """Recorders in place of a clip_step module's state and steps."""

    class State:
        model = types.SimpleNamespace(logit_scale=torch.zeros(()))
        step = 0

    def sensed(state, batch):
        rec.events.append("sensed")
        for k, v in batch.items():
            rec.keep(k, v)
        return state, {"loss/contrastive": 1.0}

    def nosense(state, batch):
        rec.events.append("unsensed")
        return state, {"loss/contrastive": 1.0}

    mp.setattr(module, "create_clip_train_state", lambda *a, **kw: State())
    mp.setattr(module, "clip_train_step", sensed)
    mp.setattr(module, "make_nosense_step", lambda cfg: nosense)


# (preset, batch, steps, sense stride, scan k): per-step; the headline's
# stride 8; the fused sense 32 x 32; a fused k without a stride; a k
# smaller than the stride.
SCHEDULES = [
    ("vit_b16_hd128", 2, 3, 1, 0),
    ("vit_b16_hd128", 2, 20, 8, 0),
    ("tiny_hd128", 2, 96, 32, 32),
    ("tiny", 2, 5, 1, 4),
    ("tiny_hd128", 2, 10, 8, 4),
]


@pytest.mark.parametrize("preset,batch,steps,stride,k", SCHEDULES)
def test_bench_schedule_and_batch_are_the_references(ref, port, monkeypatch, preset, batch,
                                                     steps, stride, k):
    import forde_tpu.train.clip_step as jax_clip_step
    import forde_tpu_torch.train.clip_step as torch_clip_step

    runs = {}
    for side, mod, clip_step in (("reference", ref.bench, jax_clip_step),
                                 ("port", port.bench, torch_clip_step)):
        rec = Recorder()
        with monkeypatch.context() as mp:
            stub_clip_steps(mp, clip_step, rec)
            mp.setattr(mod, "time", rec.time_module())
            if side == "reference":
                mp.setattr(mod, "jax", fake_jax())
                rate = mod.run_preset(preset, batch, steps, stride, scan_k=k)
            else:
                rate = mod.run_preset(preset, batch, steps, stride, scan_k=k, device="cpu")
        runs[side] = (rate, rec.sections(), rec.arrays)
    (r_rate, (r_warm, r_timed, r_all), r_batch) = runs["reference"]
    (p_rate, (p_warm, p_timed, p_all), p_batch) = runs["port"]
    assert p_warm == r_warm and p_timed == r_timed and p_all == r_all
    assert p_rate == r_rate
    assert r_timed.count("sensed") >= 1
    assert r_batch.keys() == p_batch.keys()
    for key in r_batch:
        assert p_batch[key].dtype == r_batch[key].dtype, key
        np.testing.assert_array_equal(p_batch[key], r_batch[key])


def test_bench_main_runs_the_references_presets(ref, port, monkeypatch, capsys):
    """main's calls of run_preset (preset, batch, steps, stride, k) and
    the rates it reports, with run_preset stubbed on both sides."""
    out = {}
    for side, mod in (("reference", ref.bench), ("port", port.bench)):
        calls = []

        def run_preset(preset, batch, steps, sense_interval=1, scan_k=0, *, calls=calls,
                       stats=None, **kw):
            calls.append((preset, batch, steps, sense_interval, scan_k))
            if stats is not None:
                stats.update(launches={}, peak_gib=None, ms_per_step=1.0, first_call_s=1.0)
            return 1000.0 + len(calls) + 0.123
        monkeypatch.setattr(mod, "run_preset", run_preset)
        mod.main() if side == "reference" else mod.main(device="cpu")
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        out[side] = (calls, line)
    (r_calls, r_line), (p_calls, p_line) = out["reference"], out["port"]
    assert p_calls == r_calls
    assert len(r_calls) == 3 + 1 + 3  # the presets, the headline's stride, 3 fused runs
    assert p_line["metric"] == r_line["metric"] == (
        "image_text_pairs_per_sec_per_chip_vit_b16_hd128_sense8_bf16")
    assert p_line["value"] == r_line["value"]
    assert p_line["vs_baseline"] is None and p_line["unit"] == r_line["unit"]
    assert {k: p_line["extra"][k] for k in r_line["extra"]} == r_line["extra"]


def test_decoder_schedule_and_tokens_are_the_references(ref, port, monkeypatch, capsys):
    import forde_tpu.train.state as jax_state
    import forde_tpu.train.step as jax_step
    import forde_tpu_torch.train.state as torch_state
    import forde_tpu_torch.train.step as torch_step

    runs = {}
    for side, mod, state_mod, step_mod in (("reference", ref.decoder, jax_state, jax_step),
                                           ("port", port.decoder, torch_state, torch_step)):
        rec = Recorder()

        def train_step(state, b, aux_loss_weight, rec=rec):
            rec.events.append(("step", aux_loss_weight))
            rec.keep("input_ids", b["input_ids"])
            return state, {"loss/total": 2.0}
        with monkeypatch.context() as mp:
            mp.setattr(state_mod, "create_train_state", lambda *a, **kw: "state")
            mp.setattr(step_mod, "train_step", train_step)
            mp.setattr(mod, "time", rec.time_module())
            if side == "reference":
                mp.setattr(mod, "jax", fake_jax())
                tok_s = mod.bench("capacity", batch=2, seq=16)
            else:
                tok_s = mod.bench("capacity", batch=2, seq=16, device="cpu")
        runs[side] = (tok_s, rec.sections(), rec.arrays["input_ids"],
                      capsys.readouterr().out)
    r, p = runs["reference"], runs["port"]
    assert p[0] == r[0] and p[1] == r[1] and p[3] == r[3]
    assert r[1][1] == [("step", 1.0)] * 10 and len(r[1][0]) == 2
    assert p[2].dtype == r[2].dtype
    np.testing.assert_array_equal(p[2], r[2])


def serving_args(mod, argv):
    """The parsed flags of a serving_bench module."""
    if hasattr(mod, "parser"):
        return mod.parser().parse_args(argv)
    with pytest.MonkeyPatch.context() as mp:
        captured = {}

        def build(args):
            captured["args"] = args
            raise StopIteration
        mp.setattr(mod, "build", build)
        mp.setattr(sys, "argv", ["serving_bench.py", *argv])
        with pytest.raises(StopIteration):
            mod.main()
    return captured["args"]


SERVING_ARGV = ["--requests", "12", "--min_prompt", "8", "--max_prompt", "64", "--min_new",
                "4", "--max_new", "32", "--seed", "3", "--load_rate", "7.5"]


def test_serving_workload_and_arrivals_are_the_references(ref, port):
    import forde_tpu.core.config as jax_config
    import forde_tpu_torch.core.config as torch_config

    r_args = serving_args(ref.serving, SERVING_ARGV)
    p_args = serving_args(port.serving, SERVING_ARGV)
    r_prompts, r_budgets = ref.serving.workload(r_args, jax_config.LLMConfig(vocab_size=50_304))
    p_prompts, p_budgets = port.serving.workload(p_args, torch_config.LLMConfig(vocab_size=50_304))
    assert p_prompts == r_prompts
    assert p_budgets.dtype == r_budgets.dtype
    np.testing.assert_array_equal(p_budgets, r_budgets)
    # the reference draws its arrivals inline (serving_bench.py:427-429)
    rng = np.random.RandomState(r_args.seed + 7)
    want = np.cumsum(rng.exponential(1.0 / r_args.load_rate, r_args.requests))
    np.testing.assert_array_equal(port.serving.arrivals(p_args), want)


def test_pctl_is_the_references(ref, port):
    rng = np.random.RandomState(0)
    for xs in ([], [0.5], list(rng.exponential(0.1, 37)), [3, 1, 2, 2]):
        for q in (50, 90, 99):
            assert port.serving._pctl(xs, q) == ref.serving._pctl(xs, q)


def run_serving_stubbed(mod, side, argv, monkeypatch, capsys):
    """main with every engine stubbed: (printed lines, the engines' calls)."""
    calls = []
    recs = [{"ttft": 0.25 * (i + 1), "tpot": 0.01 * i, "n": 1 + i % 3} for i in range(6)]

    def stub(name, value):
        def run(*args, **kw):
            data = [a for a in args if isinstance(a, (list, np.ndarray))]
            calls.append((name, [np.asarray(d).tolist() if isinstance(d, np.ndarray) else d
                                 for d in data], sorted(kw.items())))
            return value if side == "reference" else (value, {})
        return run
    if side == "reference":
        import forde_tpu.core.config as config
        build = lambda args: (config.LLMConfig(vocab_size=50_304, max_seq_len=args.max_seq_len),
                              None, None)
    else:
        import forde_tpu_torch.core.config as config
        build = lambda args, device, cfg=None: (
            config.LLMConfig(vocab_size=50_304, max_seq_len=args.max_seq_len), None)
    with monkeypatch.context() as mp:
        mp.setattr(mod, "build", build)
        mp.setattr(mod, "run_sequential", stub("sequential", 2.0))
        mp.setattr(mod, "run_ragged", stub("ragged", 0.5))
        mp.setattr(mod, "run_pool", stub("pool", (0.75, 9)))
        mp.setattr(mod, "run_prefix", stub("prefix", (1.5, 0.6)))
        mp.setattr(mod, "run_load_ragged", stub("load_ragged", (recs, 3.0)))
        mp.setattr(mod, "run_load_pool", stub("load_pool", (recs[::-1], 2.5)))
        if side == "reference":
            mp.setattr(sys, "argv", ["serving_bench.py", *argv])
            mod.main()
        else:
            mod.main([*argv, "--device", "cpu"])
    return capsys.readouterr().out.strip().splitlines(), calls


@pytest.mark.parametrize("extra", [
    [],
    ["--decode_fuse", "4", "--prefill_chunk", "16", "--load_prefix"],
    ["--nsa", "--prefill_chunk", "16", "--load_prefix"],
    ["--skip", "sequential,prefix", "--no_warm"],
])
def test_serving_reports_are_the_references(ref, port, monkeypatch, capsys, extra):
    argv = SERVING_ARGV + extra
    r_lines, r_calls = run_serving_stubbed(ref.serving, "reference", argv, monkeypatch, capsys)
    p_lines, p_calls = run_serving_stubbed(port.serving, "port", argv, monkeypatch, capsys)
    # the reference's lines, then the port's one JSON line
    assert p_lines[:-1] == r_lines
    assert len(r_lines) >= 4
    # the engines got the same prompts, budgets, arrivals and options
    assert p_calls == r_calls
    last = json.loads(p_lines[-1])
    assert last["metric"] == "serving_out_tok_per_s_continuous_pool"
    modes = [json.loads(line) for line in r_lines[1:]]
    pool = [m for m in modes if m["mode"] == "continuous_pool"]
    assert last["value"] == pool[0]["out_tok_per_s"]
    for m in modes:
        if m["mode"] != "continuous_pool":
            assert last["extra"][m["mode"]] == m
    assert set(last["extra"]["launches"]) == {m["mode"] for m in modes}


def test_quant_decode_runs_are_the_references(ref, port, monkeypatch, capsys):
    import forde_tpu_torch.models.decoder_lm as torch_decoder_lm
    import forde_tpu_torch.models.generate as torch_generate
    import forde_tpu_torch.ops.quant as torch_quant

    argv = ["--new", "4", "--reps", "2", "--prompt_len", "5"]
    runs = {}
    for side, mod in (("reference", ref.quant), ("port", port.quant)):
        rec = Recorder()

        class Model:
            def __init__(self, config=None, **kw):
                self.config = config

            def init(self, key, prompt):
                return {"params": {}}

            def eval(self):
                return self

        def generate_cached(model, *args, max_new_tokens, temperature, rec=rec, **kw):
            prompt = args[0] if side == "port" else args[1]
            rec.events.append(("generate", bool(model.config.quantized), max_new_tokens,
                               temperature))
            rec.keep("prompt", prompt)
            return np.zeros((1, prompt.shape[1] + max_new_tokens), np.int32)
        with monkeypatch.context() as mp:
            mp.setattr(mod, "time", rec.time_module())
            if side == "reference":
                mp.setattr(mod, "FORDEDecoderLM", Model)
                mp.setattr(mod, "generate_cached", generate_cached)
                mp.setattr(mod, "quantize_params", lambda p: p)
                mp.setattr(sys, "argv", ["quant_decode.py", *argv])
                mod.main()
            else:
                mp.setattr(torch_decoder_lm, "FORDEDecoderLM", Model)
                mp.setattr(torch_generate, "generate_cached", generate_cached)
                mp.setattr(torch_quant, "quantize_params",
                           lambda m: Model(m.config.replace(quantized=True)))
                mod.main([*argv, "--device", "cpu"])
        runs[side] = (rec.events, rec.arrays["prompt"], capsys.readouterr().out.splitlines())
    r, p = runs["reference"], runs["port"]
    assert p[0] == r[0]
    assert [e for e in r[0] if e != "T"] == (
        [("generate", False, 4, 0)] * 3 + [("generate", True, 4, 0)] * 3)
    assert p[1].dtype == r[1].dtype
    np.testing.assert_array_equal(p[1], r[1])
    assert p[2][:-1] == r[2]
    last = json.loads(p[2][-1])
    assert last["metric"] == "decode_tokens_per_sec_batch1_int8"
    assert last["extra"]["int8_speedup"] == pytest.approx(1.0)


def test_decode_scaling_runs_are_the_references(ref, port, monkeypatch, capsys):
    import forde_tpu.models.decoder_lm as jax_decoder_lm
    import forde_tpu.models.generate as jax_generate
    import forde_tpu.train.state as jax_state
    import forde_tpu_torch.models.generate as torch_generate
    import forde_tpu_torch.train.state as torch_state

    runs = {}
    for side, mod in (("reference", ref.scaling), ("port", port.scaling)):
        rec = Recorder()

        def create_train_state(cfg, *args, **kw):
            rec.events.append(("state", cfg.max_seq_len, cfg.use_sparse_attention,
                               cfg.num_layers, cfg.window_size, cfg.d_model))
            model = types.SimpleNamespace(config=cfg, eval=lambda: model)
            return types.SimpleNamespace(params={}, stats_buffer={}, model=model)

        def generate_cached(model, *args, max_new_tokens, temperature, rec=rec, **kw):
            prompt = args[0] if side == "port" else args[1]
            rec.events.append(("generate", max_new_tokens, temperature))
            rec.keep("prompt", prompt)
            return torch.zeros(1, 1) if side == "port" else np.zeros((1, 1))
        with monkeypatch.context() as mp:
            mp.setattr(mod, "time", rec.time_module())
            if side == "reference":
                mp.setattr(jax_state, "create_train_state", create_train_state)
                mp.setattr(jax_generate, "generate_cached", generate_cached)
                mp.setattr(jax_decoder_lm, "FORDEDecoderLM", lambda config: None)
                mp.setattr(sys, "argv", ["decode_scaling.py", "--new", "8", "--layers", "2"])
                mod.main()
            else:
                mp.setattr(torch_state, "create_train_state", create_train_state)
                mp.setattr(torch_generate, "generate_cached", generate_cached)
                mod.main(["--new", "8", "--layers", "2", "--device", "cpu"])
        runs[side] = (rec.events, rec.arrays["prompt"], capsys.readouterr().out.splitlines())
    r, p = runs["reference"], runs["port"]
    assert p[0] == r[0]
    assert [e[1] for e in r[0] if e[0] == "state"] == [2048, 16384]
    assert p[1].dtype == r[1].dtype
    np.testing.assert_array_equal(p[1], r[1])
    assert p[2][:-1] == r[2]
    last = json.loads(p[2][-1])
    assert last["metric"] == "decode_ms_per_token_ratio_16384_over_2048"
    assert last["value"] == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# (d) and (e): the port's drivers end to end on the CPU, and their refusal
# without a GPU.


def tiny_lm(**kw):
    from forde_tpu_torch.core.config import LLMConfig

    return LLMConfig(vocab_size=1024, d_model=64, num_layers=1, num_heads=1, head_dim=64,
                     max_seq_len=128, num_experts=2, expert_hidden_dim=64, window_size=16,
                     compression_ratio=4, top_k_global=8, num_streams=2,
                     dropout_rate=0.0).replace(**kw)


def tiny_dual_encoder():
    from forde_tpu_torch.core.config import DualEncoderConfig, TowerConfig

    tower = TowerConfig(d_model=64, num_layers=1, num_heads=1, head_dim=64, mlp_hidden_dim=128)
    return DualEncoderConfig(image_size=32, patch_size=16, vision=tower, vocab_size=100,
                             text=tower, embed_dim=32)


def drive(name, port, monkeypatch):
    """Driver ``name`` end to end on the CPU at a tiny width."""
    if name == "bench":
        for k, v in dict(BENCH_STEPS="2", BENCH_BATCH="2", BENCH_SENSE_STRIDE="2",
                         BENCH_SCAN_EXTRA="4", BENCH_SCAN_STRIDE="2").items():
            monkeypatch.setenv(k, v)
        port.bench.main(device="cpu", config=tiny_dual_encoder())
    elif name == "decoder":
        monkeypatch.setenv("DECODER_SEQ", "32")
        monkeypatch.setenv("DECODER_BATCH", "2")
        port.decoder.main(["--device", "cpu"], config=tiny_lm(), steps=2)
    elif name == "serving_dense":
        port.serving.main(["--device", "cpu", "--requests", "4", "--min_prompt", "4",
                           "--max_prompt", "8", "--min_new", "2", "--max_new", "4",
                           "--prefix_len", "8", "--load_rate", "200", "--decode_fuse", "2"],
                          config=tiny_lm(use_sparse_attention=False))
    elif name == "serving_nsa":
        port.serving.main(["--device", "cpu", "--nsa", "--requests", "4", "--min_prompt", "4",
                           "--max_prompt", "32", "--min_new", "2", "--max_new", "4",
                           "--load_rate", "200"], config=tiny_lm())
    elif name == "quant_decode":
        port.quant.main(["--device", "cpu", "--new", "4", "--reps", "1", "--prompt_len", "8"],
                        config=tiny_lm(use_sparse_attention=False, use_hyper_connections=False))
    elif name == "decode_scaling":
        port.scaling.main(["--device", "cpu", "--new", "4"], config=tiny_lm())


METRICS = {
    "bench": "image_text_pairs_per_sec_per_chip_vit_b16_hd128_sense2_bf16",
    "decoder": "decoder_tokens_per_sec_per_chip_dense",
    "serving_dense": "serving_out_tok_per_s_continuous_pool",
    "serving_nsa": "serving_out_tok_per_s_continuous_pool",
    "quant_decode": "decode_tokens_per_sec_batch1_int8",
    "decode_scaling": "decode_ms_per_token_ratio_16384_over_2048",
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_driver_runs_on_the_cpu_and_ends_in_one_json_line(name, port, monkeypatch, capsys):
    drive(name, port, monkeypatch)
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert last["metric"] == METRICS[name]
    assert isinstance(last["value"], float) and math.isfinite(last["value"])
    assert last["value"] > 0
    assert last["vs_baseline"] is None
    extra = last["extra"]
    assert extra["card"] is None and extra["device"] == "cpu"  # a CPU run names no card
    assert "peak_gib" in extra and "launches" in extra


@pytest.mark.parametrize("name", ["bench", "decoder", "serving_bench", "quant_decode",
                                  "decode_scaling"])
def test_driver_refuses_without_a_gpu(name, port, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        if name == "bench":
            port.bench.main()
        else:
            {"decoder": port.decoder, "serving_bench": port.serving,
             "quant_decode": port.quant, "decode_scaling": port.scaling}[name].main([])
