"""Synthetic vision-language batches (port of ``SyntheticVLDataset`` in
forde_tpu/data/vl.py, numpy only, the same random stream).

The preprocessing contract of the JAX package's pipelines: (B, 224, 224,
3) float32 images in [0, 1], and right-padded ``input_ids`` /
``attention_mask`` of length 64. Text lengths are drawn from 4 to the text
length, so the text tower runs its per-sample ``kv_lens`` route. The
streamed Conceptual Captions pipeline is not ported.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

MAX_TEXT_LENGTH = 64
IMAGE_SIZE = 224


class SyntheticVLDataset:
    """Seeded random (image, caption-token) pairs for tests and benchmarks."""

    def __init__(
        self,
        batch_size: int,
        num_batches: int = 100,
        image_size: int = IMAGE_SIZE,
        text_len: int = MAX_TEXT_LENGTH,
        vocab_size: int = 30522,
        seed: int = 42,
        pool: int = 0,
    ):
        """``pool`` > 0 pregenerates that many distinct batches and cycles
        them: fresh batches cost host time that a throughput run should
        not measure."""
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.image_size = image_size
        self.text_len = text_len
        self.vocab_size = vocab_size
        self.seed = seed
        self.pool = pool

    def __len__(self):
        return self.num_batches

    def _gen(self, rng) -> Dict[str, np.ndarray]:
        lengths = rng.randint(4, self.text_len + 1, size=self.batch_size)
        input_ids = np.zeros((self.batch_size, self.text_len), np.int32)
        mask = np.zeros((self.batch_size, self.text_len), np.int32)
        for i, ln in enumerate(lengths):
            input_ids[i, :ln] = rng.randint(1, self.vocab_size, size=ln)
            mask[i, :ln] = 1
        return {
            "image": rng.rand(
                self.batch_size, self.image_size, self.image_size, 3
            ).astype(np.float32),
            "input_ids": input_ids,
            "attention_mask": mask,
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        if self.pool > 0:
            cache = [self._gen(rng) for _ in range(self.pool)]
            for i in range(self.num_batches):
                yield cache[i % self.pool]
            return
        for _ in range(self.num_batches):
            yield self._gen(rng)
