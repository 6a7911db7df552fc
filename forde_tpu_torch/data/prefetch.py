"""Device prefetch: host batch assembly and host-to-device copies overlap
the steps (port of forde_tpu/data/prefetch.py).

A background thread turns each numpy batch into tensors in pinned host
memory. On CUDA the consumer issues each batch's copies ``size``
batches ahead, ``non_blocking`` on a side stream, and the compute stream
waits on that copy's event only when it takes the batch. A uint8 image
crosses as bytes and becomes fp32 in [0, 1] on the device.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


def _to_device(batch: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        v = v.to(device, non_blocking=True)
        out[k] = v.float() / 255.0 if v.dtype == torch.uint8 else v
    return out


def prefetch_to_device(
    iterator: Iterator[Dict[str, np.ndarray]],
    device: torch.device,
    size: int = 2,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host batch iterator (dicts of numpy arrays) with a queue of
    ``size`` batches assembled ahead in pinned memory and copied ahead to
    ``device``."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    # Consumers stop early (a train loop at --num_steps): the stop event and
    # the timed puts end the producer soon after the consumer goes away.
    stop = threading.Event()

    def put_q(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if stop.is_set():
                    return
                host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
                if pin:
                    host = {k: v.pin_memory() for k, v in host.items()}
                if not put_q(host):
                    return
            put_q(sentinel)
        except BaseException as exc:  # noqa: BLE001 — re-raised in the consumer
            put_q(exc)

    def take():
        item = q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        if not pin:
            while (item := take()) is not sentinel:
                yield _to_device(item, device)
            return
        copy_stream = torch.cuda.Stream(device)
        pending: collections.deque = collections.deque()
        done = False

        def issue():
            nonlocal done
            item = take()
            if item is sentinel:
                done = True
                return
            with torch.cuda.stream(copy_stream):
                dev = _to_device(item, device)
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            pending.append((dev, ready))

        for _ in range(size):
            if not done:
                issue()
        while pending:
            dev, ready = pending.popleft()
            compute = torch.cuda.current_stream(device)
            compute.wait_event(ready)
            for t in dev.values():
                t.record_stream(compute)
            yield dev
            if not done:
                issue()
    finally:
        stop.set()
        try:  # unblock a producer waiting on a full queue
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
