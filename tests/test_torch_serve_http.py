"""The port's HTTP daemon (forde_tpu_torch.serve_http) on the CPU, serving a
checkpoint of the JAX package's weights (test_torch_decoder_lm.py's small
config, max_seq_len 64, written as ``model_config.json`` + ``params.npz``).

The server runs in-process on 127.0.0.1, port 0. Cases of
tests/test_serve_http.py: concurrent requests of mixed lengths coalesce
into one ragged batch and each returns exactly the JAX package's greedy
tokens; per-request ``max_new_tokens`` trims; bad requests get 400 and an
unknown path 404; continuous mode (dense and NSA) and ``--decode_fuse 4``
return the greedy tokens with the pool's rows overlapping, and /stats
counts the pool's work and times its spans. Also: what
``make_server`` refuses, and that it runs on CUDA unless told otherwise.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from forde_tpu.train.checkpoint import save_model_config
from forde_tpu_torch import interop, serve, serve_http
from forde_tpu_torch.obs import spans

from test_torch_decode_pool import setup_variant, want

torch.set_num_threads(1)

PROMPTS = [[5, 17, 20], [9, 9], [7, 3, 11, 8, 2]]
NSA_PROMPTS = [np.random.RandomState(4).randint(1, 256, n).tolist() for n in (24, 9, 19)]
MAX_NEW = 3  # batch mode's server maximum
POOL_NEW = 8  # continuous mode's


def checkpoint(tmp_path_factory, name, prompts, new):
    """setup_variant's namespace, its JAX variables written as a checkpoint
    (``ckpt``) that the server loads."""
    v = setup_variant(name, prompts, new)
    v.ckpt = str(tmp_path_factory.mktemp(f"ckpt_{name}"))
    save_model_config(v.ckpt, v.cfg, {"step": 0})
    np.savez(f"{v.ckpt}/params.npz", **interop.flatten(v.jax[1]))
    return v


def start_server(ckpt, *flags, max_new=MAX_NEW):
    """(server, batcher, base url), serving on a thread of its own."""
    args = serve_http.add_server_args(serve.build_parser()).parse_args([
        "--checkpoint_dir", ckpt, "--device", "cpu", "--port", "0",
        "--max_new_tokens", str(max_new), "--temperature", "0", *flags,
    ])
    srv, batcher = serve_http.make_server(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    host, port = srv.server_address[:2]
    return srv, batcher, f"http://{host}:{port}"


def stop_server(srv, batcher):
    srv.shutdown()
    batcher.stop()
    srv.server_close()


def post(url, payload, path="/generate", timeout=120):
    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


def concurrent(url, payloads):
    """POST every payload from a thread of its own; the responses in order."""
    results = [None] * len(payloads)

    def worker(i):
        results[i] = post(url, payloads[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(r is not None for r in results), results
    return results


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return checkpoint(tmp_path_factory, "dense", PROMPTS, POOL_NEW)


@pytest.fixture(scope="module")
def nsa(tmp_path_factory):
    return checkpoint(tmp_path_factory, "nsa", NSA_PROMPTS, POOL_NEW)


@pytest.fixture(scope="module")
def server(dense):
    srv, batcher, url = start_server(dense.ckpt, "--batch_window_ms", "1000", "--max_batch", "8")
    yield url, batcher
    stop_server(srv, batcher)


def test_http_concurrent_mixed_lengths_batch_and_match_greedy(server, dense):
    url, batcher = server
    assert get(url, "/healthz")["status"] == "ok"
    results = concurrent(url, [{"prompt_ids": p} for p in PROMPTS])
    for p, r in zip(PROMPTS, results):
        assert r["output_ids"] == want(dense, p, MAX_NEW)
        assert r["prompt_len"] == len(p) and r["batch_rows"] == 4  # 3 rows, a power of two
    stats = get(url, "/stats")
    assert stats["requests"] >= 3 and stats["rows_decoded"] >= 3
    assert stats["tokens_generated"] >= 9
    # the 1 s window coalesced the concurrent requests
    assert stats["batches"] < stats["requests"] and stats["rows_padding"] >= 1


def test_http_per_request_max_new_trims(server, dense):
    url, _ = server
    r = post(url, {"prompt_ids": [5, 17, 20], "max_new_tokens": 2})
    assert r["output_ids"] == want(dense, [5, 17, 20], 2)
    full = post(url, {"prompt_ids": [5, 17, 20]})
    assert r["output_ids"] == full["output_ids"][:5]


def test_http_rejects_bad_requests(server):
    url, _ = server
    for path, payload in (
        ("/generate", {}),  # no prompt
        ("/generate", {"prompt_ids": []}),
        ("/generate", {"prompt_ids": ["a", "b"]}),
        ("/generate", {"prompt_ids": [1, -2]}),
        ("/generate", {"prompt_ids": [1, 2], "max_new_tokens": 99}),  # > the server's maximum
        ("/generate", {"prompt_ids": list(range(62))}),  # > max_seq_len 64 - 3
        ("/generate", {"prompt_ids": [1, 2], "temperature": 0.5}),  # batch mode
        ("/generate", {"prompt_ids": [1, 2], "stream": True}),  # batch mode
        ("/generate", {"prompt_ids": [1, 2], "prefix_id": 0}),  # batch mode
        ("/prefix", {"prefix_ids": [1, 2]}),  # batch mode
    ):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(url, payload, path)
        assert e.value.code == 400, payload
        assert json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        with urllib.request.urlopen(url + "/nope", timeout=30):
            pass
    assert e.value.code == 404


@pytest.mark.parametrize("name,fuse", [("dense", 1), ("nsa", 1), ("dense", 4), ("nsa", 4)])
def test_http_continuous_exact_and_overlapping(request, name, fuse):
    """Continuous mode, and --decode_fuse 4 (no budget a multiple of 4:
    each ends inside a fused call): more concurrent requests than pool
    rows, different budgets, each equal to the JAX greedy tokens, the
    pool's two rows in use together."""
    v = request.getfixturevalue(name)
    prompts = PROMPTS if name == "dense" else NSA_PROMPTS
    budgets = [7, 5, 6]
    spans.reset()
    srv, batcher, url = start_server(v.ckpt, "--continuous", "--max_batch", "2",
                                     "--decode_fuse", str(fuse), max_new=POOL_NEW)
    try:
        assert get(url, "/healthz")["nsa"] is (name == "nsa")
        results = concurrent(url, [{"prompt_ids": p, "max_new_tokens": b}
                                   for p, b in zip(prompts, budgets)])
        for p, b, r in zip(prompts, budgets, results):
            assert r["output_ids"] == want(v, p, b)
            assert r["batch_rows"] == 2
        stats = get(url, "/stats")
        assert stats["requests"] == 3 and stats["ticks"] >= 2
        assert stats["tokens_generated"] == sum(budgets)
        assert stats["max_active_rows"] == 2  # the pool overlapped requests
        # the pool's own counters and span times (obs/spans.py)
        pool, times = stats["pool"], stats["spans"]
        assert pool["pool.submitted"] == pool["pool.admitted"] == 3
        assert pool["pool.steps"] == fuse * times["pool.step"]["count"]
        assert pool["pool.rows_stepped"] >= sum(b - 1 for b in budgets)
        if fuse == 1:  # no surplus tokens: every row step is a token served
            assert pool["pool.rows_stepped"] == sum(b - 1 for b in budgets)
        prefill = ["prefill.forward"] + (["prefill.cache"] if name == "nsa" else [])
        for span in ["pool.queue", "pool.prefill", "pool.insert"] + prefill:
            assert times[span]["count"] == 3, span
        assert set(times) == {"pool.queue", "pool.prefill", "pool.insert", "pool.step", *prefill}
        assert all(0 <= t["mean_ms"] <= t["max_ms"] for t in times.values())
    finally:
        stop_server(srv, batcher)


def test_make_server_refusals(dense, nsa):
    """What the reference refuses (beam search, speculative decoding,
    --prefix_ids and --prefill_chunk on NSA), --use_ema on a checkpoint
    trained without an EMA, and the default device: CUDA, which raises
    with no GPU visible."""
    base = ["--device", "cpu", "--port", "0"]

    def make(*flags):
        return serve_http.make_server(
            serve_http.add_server_args(serve.build_parser()).parse_args([*base, *flags]))

    for flags, match in (
        (["--checkpoint_dir", dense.ckpt, "--beam_size", "2"], "greedy/sampled"),
        (["--checkpoint_dir", dense.ckpt, "--draft_checkpoint_dir", dense.ckpt],
         "greedy/sampled"),
        (["--checkpoint_dir", nsa.ckpt, "--prefix_ids", "1,2"], "dense-causal"),
        (["--checkpoint_dir", nsa.ckpt, "--continuous", "--prefill_chunk", "4"],
         "dense-causal"),
    ):
        with pytest.raises(SystemExit, match=match):
            make(*flags)
    with pytest.raises(ValueError, match="no EMA weights"):  # trained without --ema_decay
        make("--checkpoint_dir", dense.ckpt, "--use_ema")
    if not torch.cuda.is_available():
        args = serve_http.add_server_args(serve.build_parser()).parse_args(
            ["--checkpoint_dir", dense.ckpt, "--port", "0"])
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="no GPU is visible"):
            serve_http.make_server(args)
