"""Decode step time against max_seq_len on one card (port of
benchmarks/decode_scaling.py).

The NSA decode caches keep the local branch as a ring buffer of
window_size K/V rows, so a step's attention work is bounded by the window
and K; what still grows with max_seq_len (= max_decode_len) is the
compressed branch's pool cache, max_seq_len // ratio means. This decodes
the same ``--new`` greedy tokens from the same seeded 64-token prompt at
max_seq_len 2,048 and 16,384 (the JAX package's small test config at d
256, 4 heads, window 512, ``--layers`` layers, fp32) and reports ms per
token for both and their ratio: well under 8x (the buffer's growth) is
the reference's pass mark. Each length: one untimed call (on the card it
captures the decode graph), then one timed call ending in
``torch.cuda.synchronize()``.

At 16,384 positions the compressed branch holds 4,096 pools: the decode
step's small-KV call takes them all (``small_kv_fwd`` takes up to
``FWD_MAX_KEYS`` keys), its fp32 route cutting them into chunks over the
card's blocks (``fwd_chunks``), so the pools' growth costs bytes, not
more walks.

Substitutions: ``scan_layers`` is a checkpoint layout in the port, not a
loop; the weights come from a ``torch.Generator`` seeded 0.

Prints the reference's lines, then ONE JSON line:
``decode_ms_per_token_ratio_16384_over_2048``, with both ms per token,
each length's peak GiB and the launches of its timed call, and the card
in ``extra``.

    python3 -m forde_tpu_torch.benchmarks.decode_scaling [--new 128]
        [--layers 4] [--no_nsa] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from forde_tpu_torch import kernels, resolve_device
from forde_tpu_torch.benchmarks import peak_gib, release, reset_peak, result_line, sync


def measure(max_len: int, layers: int, new_tokens: int, nsa: bool, *, device=None,
            config=None, stats: Optional[dict] = None) -> float:
    """ms per token of ``new_tokens`` greedy tokens at ``max_len``.
    ``config``: an ``LLMConfig`` in place of the reference's (its
    ``max_seq_len`` set to ``max_len``)."""
    from forde_tpu_torch.core.config import create_default_config
    from forde_tpu_torch.models.generate import generate_cached
    from forde_tpu_torch.train.state import create_train_state

    device = resolve_device(device)
    base = config if config is not None else create_default_config().replace(
        d_model=256, num_layers=layers, num_heads=4, use_sparse_attention=nsa,
        window_size=512, scan_layers=True, dropout_rate=0.0,
    )
    cfg = base.replace(max_seq_len=max_len)
    reset_peak(device)
    state = create_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), 1e-4, 0.0, device=device,
    )
    model = state.model.eval()
    prompt = torch.from_numpy(
        np.random.RandomState(0).randint(1, 1000, (1, 64)).astype(np.int32)
    ).to(device)

    def run():
        out = generate_cached(
            model, prompt, None, max_new_tokens=new_tokens, temperature=0.0,
        )
        sync(device)
        return out.cpu()  # host sync

    run()  # warm-up (the decode graph's capture on the card)
    kernels.reset_launches()
    t0 = time.perf_counter()
    run()
    dt = time.perf_counter() - t0
    ms_tok = dt / new_tokens * 1e3
    if stats is not None:
        stats.update(launches=dict(kernels.launches), peak_gib=peak_gib(device))
    print(f"max_decode_len={max_len:6d}  {ms_tok:6.2f} ms/token "
          f"({new_tokens} tokens in {dt:.2f} s)", flush=True)
    return ms_tok


def main(argv=None, *, config=None) -> None:
    """Both lengths, their ratio, and the JSON line. ``config``: an
    ``LLMConfig`` in place of the reference's (a tiny width for a CPU
    run); not a flag."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--new", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--no_nsa", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    runs = {2048: {}, 16384: {}}
    a = measure(2048, args.layers, args.new, not args.no_nsa, device=device, config=config,
                stats=runs[2048])
    release(device)
    b = measure(16384, args.layers, args.new, not args.no_nsa, device=device, config=config,
                stats=runs[16384])
    print(f"ratio 16384/2048: {b / a:.2f}x  "
          f"(O(max_decode_len) masking would approach ~8x)", flush=True)
    extra = {"decode_ms_per_token_2048": a, "decode_ms_per_token_16384": b,
             "new_tokens": args.new, "layers": args.layers, "nsa": not args.no_nsa}
    for name in ("peak_gib", "launches"):
        extra[name] = {str(n): r[name] for n, r in runs.items()}
    print(result_line("decode_ms_per_token_ratio_16384_over_2048", b / a, "ratio", extra,
                      device), flush=True)


if __name__ == "__main__":
    main()
