"""Administration of the port's decode pool and daemon: cancelling requests
and registering prefixes at run time (cases of tests/test_pool_admin.py),
against the JAX package's greedy tokens on the same weights.

Cancelling must free a slot without moving any other request's tokens; a
prefix registered over HTTP must serve exactly as the concatenated prompt,
and its prefill runs on the server's worker thread, the one thread that
makes device calls; an SSE client that disconnects has its slot freed and
its request never counted as served.
"""

import json
import socket
import threading
import time
import urllib.error

import numpy as np
import pytest
import torch

from forde_tpu_torch.models.decode_pool import DecodePool

from test_torch_decode_pool import add_refs, drain, setup_variant, want
from test_torch_serve_http import checkpoint, post, start_server, stop_server

torch.set_num_threads(1)

_RNG = np.random.RandomState(0)
PROMPTS = [_RNG.randint(1, 256, n).tolist() for n in (3, 21, 5, 17)]
PREFIXES = ([8, 1, 9], [2, 2, 2, 2])
SUFFIX = [5, 17, 20]


@pytest.fixture(scope="module", params=["dense", "nsa"])
def variant(request):
    return setup_variant(request.param, PROMPTS, new=6)


def test_pool_cancel_queued_and_active(variant):
    """Cancel one active and one queued request: the others drain to
    exactly their greedy tokens and the cancelled ids are never reported."""
    pool = DecodePool(variant.port, rows=2, temperature=0.0)
    rids = [pool.submit(p, max_new_tokens=6) for p in PROMPTS]
    results = dict(pool.tick())  # rids 0 and 1 hold the slots, 2 and 3 queue
    assert pool.cancel(rids[1]) is True  # active
    assert pool.cancel(rids[2]) is True  # queued
    assert pool.cancel(999) is False
    assert pool.active_rows() == 1 and len(pool.queue) == 1
    results.update(drain(pool))
    assert set(results) == {rids[0], rids[3]}
    for rid, p in ((rids[0], PROMPTS[0]), (rids[3], PROMPTS[3])):
        assert results[rid] == want(variant, p, 6), rid


@pytest.fixture(scope="module")
def dense_ckpt(tmp_path_factory):
    v = checkpoint(tmp_path_factory, "dense", [pre + SUFFIX for pre in PREFIXES], 4)
    return add_refs(v, [[9, 2]], 3)


def test_http_runtime_prefix_registration(dense_ckpt, tmp_path_factory):
    """POST /prefix, then /generate with its prefix_id: the JAX greedy tokens
    of the concatenated prompt; two prefixes coexist; the prefill ran on
    the worker thread; unknown ids get 400, and so does /prefix on NSA."""
    srv, batcher, url = start_server(dense_ckpt.ckpt, "--continuous", "--max_batch", "4",
                                     max_new=4)
    threads = []
    register = batcher.pool.register_prefix

    def recording(ids):
        threads.append(threading.current_thread())
        return register(ids)

    batcher.pool.register_prefix = recording
    try:
        pa = post(url, {"prefix_ids": PREFIXES[0]}, "/prefix")
        pb = post(url, {"prefix_ids": PREFIXES[1]}, "/prefix")
        assert (pa["prefix_len"], pb["prefix_len"]) == (3, 4)
        assert pa["prefix_id"] != pb["prefix_id"]
        assert threads == [batcher._worker, batcher._worker]
        for pre, pid in zip(PREFIXES, (pa["prefix_id"], pb["prefix_id"])):
            res = post(url, {"prompt_ids": SUFFIX, "prefix_id": pid})
            assert res["output_ids"] == want(dense_ckpt, pre + SUFFIX, 4)[len(pre):], pid
        for bad in (99, -1):
            with pytest.raises(urllib.error.HTTPError) as e:
                post(url, {"prompt_ids": [5], "prefix_id": bad})
            assert e.value.code == 400 and "unknown prefix_id" in json.loads(e.value.read())["error"]
    finally:
        stop_server(srv, batcher)
    nsa = checkpoint(tmp_path_factory, "nsa", [], 1)
    srv, batcher, url = start_server(nsa.ckpt, "--continuous", "--max_batch", "2")
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            post(url, {"prefix_ids": [1, 2, 3]}, "/prefix")
        assert e.value.code == 400 and "dense-causal" in json.loads(e.value.read())["error"]
    finally:
        stop_server(srv, batcher)


def test_http_sse_disconnect_frees_slot(dense_ckpt):
    """An SSE client on a one-row pool drops its connection after the first
    token; the next request still gets the slot and its greedy tokens, and
    the dropped request was cancelled, never served: only the follow-up's 3
    tokens are counted."""
    srv, batcher, url = start_server(dense_ckpt.ckpt, "--continuous", "--max_batch", "1",
                                     max_new=48)
    try:
        host, port = srv.server_address[:2]
        body = json.dumps({"prompt_ids": SUFFIX, "stream": True})
        with socket.create_connection((host, port), timeout=60) as s:
            s.sendall(f"POST /generate HTTP/1.1\r\nHost: {host}\r\nContent-Type: "
                      f"application/json\r\nContent-Length: {len(body)}\r\n\r\n{body}".encode())
            buf = b""
            while b"data: " not in buf:
                buf += s.recv(4096)
        res = post(url, {"prompt_ids": [9, 2], "max_new_tokens": 3})
        assert res["output_ids"] == want(dense_ckpt, [9, 2], 3)
        deadline = time.monotonic() + 10
        while batcher._inflight and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not batcher._inflight and batcher.pool.active_rows() == 0
        with batcher._lock:
            assert batcher.stats["tokens_generated"] == 3, batcher.stats
            assert batcher.stats["requests"] == 2
    finally:
        stop_server(srv, batcher)
