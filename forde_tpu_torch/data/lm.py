"""Language-model data (port of forde_tpu/data/lm.py): seeded random
tokens, the learnable Markov stream and a local corpus file, as numpy
batches {"input_ids": (B, S) int32} drawn from ``np.random.RandomState``
exactly as the JAX package draws them, so both packages train on the same
tokens. ``data/prefetch.py`` moves them to the device.

Not ported: the streamed fineweb corpus (``create_lm_dataset``) and GPT-2
tokenization; they need ``datasets``, ``transformers`` and network access.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class DummyDataset:
    """Seeded random-token batches."""

    def __init__(
        self,
        batch_size: int,
        seq_len: int,
        vocab_size: int,
        num_batches: int = 1000,
        seed: int = 42,
    ):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.num_batches = num_batches
        self.seed = seed

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        for _ in range(self.num_batches):
            yield {
                "input_ids": rng.randint(
                    0,
                    self.vocab_size,
                    size=(self.batch_size, self.seq_len),
                    dtype=np.int32,
                )
            }


class DummyBatchedDataset(DummyDataset):
    """Pre-materialized variant: generates all batches up front and
    replays them, so that every epoch sees identical data."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._batches = list(DummyDataset.__iter__(self))

    def __iter__(self):
        return iter(self._batches)


def create_dummy_dataset(
    batch_size: int, seq_len: int, vocab_size: int, num_batches: int = 1000
) -> DummyDataset:
    return DummyDataset(batch_size, seq_len, vocab_size, num_batches)


class MarkovDataset:
    """Structured synthetic token stream with a computable entropy floor.

    This process is *learnable*: tokens live in an
    ``active_vocab``-sized subset of the full id range, and each next
    token follows a fixed random permutation of its predecessor with
    probability ``p`` (uniform over the active set otherwise).

    Achievable cross-entropy floors (nats):
      * unigram-only model:  ln(active_vocab)
      * perfect model:       -(p + q)·ln(p + q) - (A-1)·q·ln(q),
        with q = (1-p)/A, A = active_vocab.
    A fresh model starts at ln(vocab_size); learning shows up as loss
    crossing ln(active_vocab) and heading for the floor.
    """

    def __init__(
        self,
        batch_size: int,
        seq_len: int,
        vocab_size: int,
        active_vocab: int = 8192,
        p: float = 0.85,
        num_batches: int = 1000,
        seed: int = 42,
    ):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.active_vocab = min(active_vocab, vocab_size)
        self.p = p
        self.num_batches = num_batches
        self.seed = seed
        rng = np.random.RandomState(seed)
        # Active token ids spread over the full id range; a fixed random
        # successor permutation defines the deterministic branch.
        self.tokens = rng.choice(
            vocab_size, size=self.active_vocab, replace=False
        ).astype(np.int32)
        self.successor = rng.permutation(self.active_vocab).astype(np.int32)

    def entropy_floor(self) -> float:
        a = self.active_vocab
        q = (1.0 - self.p) / a
        main = self.p + q
        return float(-(main * np.log(main) + (a - 1) * q * np.log(q)))

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed + 1)
        for _ in range(self.num_batches):
            # Vectorized chain over active-set *indices*, then map to ids.
            idx = np.empty((self.batch_size, self.seq_len), np.int64)
            idx[:, 0] = rng.randint(0, self.active_vocab, self.batch_size)
            noise = rng.rand(self.batch_size, self.seq_len) >= self.p
            resample = rng.randint(
                0, self.active_vocab, (self.batch_size, self.seq_len)
            )
            for t in range(1, self.seq_len):
                step = self.successor[idx[:, t - 1]]
                idx[:, t] = np.where(noise[:, t], resample[:, t], step)
            yield {"input_ids": self.tokens[idx].astype(np.int32)}


def create_markov_dataset(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    num_batches: int = 1000,
    active_vocab: int = 8192,
    p: float = 0.85,
    seed: int = 42,
) -> MarkovDataset:
    return MarkovDataset(
        batch_size, seq_len, vocab_size,
        active_vocab=active_vocab, p=p, num_batches=num_batches, seed=seed,
    )


class TextFileDataset:
    """Train/eval on a LOCAL corpus. Accepts:

      * ``.npy`` — a 1-D array of token ids (any tokenizer, any vocab);
      * anything else — raw text read as bytes, byte-level ids 0..255
        (no tokenizer, no egress); the JAX package's ``tokenizer="gpt2"``
        needs a tokenizer the repository does not have and raises.

    The token stream is packed into contiguous non-overlapping
    ``seq_len`` windows (remainder dropped), the window order is
    reshuffled each epoch (seeded), and epochs repeat until
    ``num_batches`` batches have been produced.
    """

    def __init__(
        self,
        path: str,
        batch_size: int,
        seq_len: int,
        num_batches: int = 1000,
        tokenizer: str = "byte",
        seed: int = 42,
    ):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.num_batches = num_batches
        self.seed = seed
        if path.endswith(".npy"):
            ids = np.load(path).astype(np.int32).reshape(-1)
            self.vocab_hint = int(ids.max()) + 1
        elif tokenizer != "byte":
            raise NotImplementedError(
                f"--tokenizer {tokenizer} is not ported to forde_tpu_torch (it waits for "
                "a tokenizer in the repository; see ROADMAP.md): give token ids as .npy "
                "or use byte-level ids"
            )
        else:
            with open(path, "rb") as f:
                ids = np.frombuffer(f.read(), np.uint8).astype(np.int32)
            self.vocab_hint = 256
        n_windows = len(ids) // seq_len
        if n_windows < 1:
            raise ValueError(
                f"{path}: {len(ids)} tokens < one seq_len={seq_len} window"
            )
        self.windows = ids[: n_windows * seq_len].reshape(n_windows, seq_len)

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        produced = 0
        while produced < self.num_batches:
            order = rng.permutation(len(self.windows))
            for start in range(0, len(order) - self.batch_size + 1,
                               self.batch_size):
                if produced >= self.num_batches:
                    return
                rows = order[start : start + self.batch_size]
                yield {"input_ids": self.windows[rows]}
                produced += 1
            if len(self.windows) < self.batch_size:
                # tiny corpus: sample rows with replacement instead of
                # silently yielding nothing
                rows = rng.randint(0, len(self.windows), self.batch_size)
                yield {"input_ids": self.windows[rows]}
                produced += 1


def create_text_file_dataset(
    path: str,
    batch_size: int,
    seq_len: int,
    num_batches: int = 1000,
    tokenizer: str = "byte",
    seed: int = 42,
) -> TextFileDataset:
    return TextFileDataset(
        path, batch_size, seq_len,
        num_batches=num_batches, tokenizer=tokenizer, seed=seed,
    )
