"""Synthetic vision-language batches (port of forde_tpu/data/vl.py:
``SyntheticVLDataset`` and ``AlignedSyntheticVLDataset``, numpy only, the
same random streams, so their batches equal the JAX package's bit for
bit; ``AlignedDeviceRenderer``, which renders the aligned batches on the
device; ``hold_out_eval``).

The preprocessing contract of the JAX package's pipelines: (B, 224, 224,
3) float32 images in [0, 1], and right-padded ``input_ids`` /
``attention_mask`` of length 64. Text lengths are drawn from 4 to the text
length, so the text tower runs its per-sample ``kv_lens`` route. The
streamed Conceptual Captions pipeline is not ported.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import torch

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


class AlignedSyntheticVLDataset:
    """Procedurally ALIGNED (image, caption) pairs for offline learning runs.

    ``SyntheticVLDataset`` pairs random pixels with random tokens — nothing
    to learn. Here both modalities derive from a shared per-class latent:
    the image is a low-frequency render of the latent (noisy), the caption
    is a fixed token sequence for that class. A dual encoder must align the
    towers to beat chance, and evaluating on a disjoint ``class_range``
    measures generalization, not memorization. No reference counterpart
    (the reference has no evaluation path at all).
    """

    def __init__(
        self,
        batch_size: int,
        num_batches: int = 100,
        image_size: int = IMAGE_SIZE,
        text_len: int = MAX_TEXT_LENGTH,
        vocab_size: int = 30522,
        num_classes: int = 4096,
        latent_dim: int = 16,
        grid: int = 14,
        noise: float = 0.05,
        seed: int = 42,
        class_range: Optional[tuple] = None,
        compositional: bool = True,
        num_bins: int = 16,
        distinct: bool = False,
        sample_seed: Optional[int] = None,
    ):
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.image_size = image_size
        self.text_len = text_len
        self.vocab_size = vocab_size
        self.num_classes = num_classes
        self.noise = noise
        # ``seed`` fixes the WORLD (latents/basis/captions — the class
        # identity tables); ``sample_seed`` varies only which classes are
        # drawn and the image noise. An eval set must share the training
        # world (same seed) with a different sample_seed — changing seed
        # creates a different universe and makes every eval impossible.
        self.seed = seed
        self.sample_seed = seed if sample_seed is None else sample_seed
        self.distinct = distinct
        self.class_lo, self.class_hi = class_range or (0, num_classes)
        master = np.random.RandomState(seed)
        self.latents = master.randn(num_classes, latent_dim).astype(np.float32)
        self.grid = grid
        self.basis = (
            master.randn(latent_dim, grid * grid * 3).astype(np.float32)
            / np.sqrt(latent_dim)
        )
        if compositional:
            # COMPOSITIONAL captions: token i describes latent factor i,
            # quantized into num_bins quantile bins
            # (token = 1 + i*num_bins + bin). The caption is a discretized
            # description of the SAME latent that renders the image, so a
            # dual encoder that learns the token<->factor code generalizes
            # to held-out latent combinations — random per-class captions
            # (compositional=False) make cross-class generalization
            # information-theoretically impossible.
            if vocab_size <= 1 + latent_dim * num_bins:
                raise ValueError(f"vocab_size {vocab_size} must exceed 1 + latent_dim * "
                                 f"num_bins = {1 + latent_dim * num_bins}")
            edges = np.quantile(
                master.randn(100_000), np.linspace(0, 1, num_bins + 1)[1:-1]
            )
            bins = np.stack(
                [np.digitize(self.latents[:, i], edges)
                 for i in range(latent_dim)],
                axis=1,
            )  # (C, latent_dim) in [0, num_bins)
            offsets = 1 + np.arange(latent_dim) * num_bins
            caps = (offsets[None, :] + bins).astype(np.int32)
            self.captions = np.zeros((num_classes, text_len), np.int32)
            ln = min(latent_dim, text_len)
            self.captions[:, :ln] = caps[:, :ln]
            self.cap_lens = np.full(num_classes, ln, np.int32)
        else:
            # Fixed random caption per class (round-1 behavior): length in
            # [6, text_len], ids >= 1.
            self.captions = master.randint(
                1, vocab_size, size=(num_classes, text_len)
            ).astype(np.int32)
            self.cap_lens = master.randint(
                6, text_len + 1, size=num_classes
            ).astype(np.int32)

    def __len__(self):
        return self.num_batches

    def _render(self, classes: np.ndarray, rng) -> np.ndarray:
        coarse = np.tanh(self.latents[classes] @ self.basis)  # (B, g*g*3)
        g = self.grid
        coarse = coarse.reshape(-1, g, g, 3)
        rep = int(np.ceil(self.image_size / g))
        img = np.repeat(np.repeat(coarse, rep, axis=1), rep, axis=2)
        img = img[:, : self.image_size, : self.image_size, :]
        img = (img + 1.0) / 2.0
        if self.noise:
            img = img + rng.randn(*img.shape).astype(np.float32) * self.noise
        return np.clip(img, 0.0, 1.0).astype(np.float32)

    def class_schedule(self, rng) -> np.ndarray:
        """(num_batches, B) class ids. ``distinct=True`` samples without
        replacement across the WHOLE schedule (retrieval eval needs unique
        ground truths — duplicated classes make R@K ill-defined)."""
        pool = np.arange(self.class_lo, self.class_hi)
        total = self.batch_size * self.num_batches
        if self.distinct and pool.size >= total:
            return rng.choice(pool, size=total, replace=False).reshape(
                self.num_batches, self.batch_size
            )
        return np.stack([
            rng.choice(pool, size=self.batch_size,
                       replace=self.batch_size > pool.size)
            for _ in range(self.num_batches)
        ])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.sample_seed + 7)
        for classes in self.class_schedule(rng):
            ids = self.captions[classes].copy()
            mask = (
                np.arange(self.text_len)[None, :]
                < self.cap_lens[classes][:, None]
            ).astype(np.int32)
            ids *= mask
            yield {
                "image": self._render(classes, rng),
                "input_ids": ids,
                "attention_mask": mask,
            }


class AlignedDeviceRenderer:
    """Renders ``AlignedSyntheticVLDataset``'s batches on the device.

    The class tables (latents, basis, captions, caption lengths) are
    uploaded once; each batch then crosses from the host as its (B,) class
    ids only, and its images are made on the device (no host-to-device
    image copy). The classes are the numpy dataset's, drawn on the host
    from the same stream; ids and masks equal the dataset's exactly, and
    the images equal its ``tanh(latents @ basis)`` render up to fp32
    rounding. The noise comes from a ``torch.Generator`` seeded with
    ``sample_seed + 13`` (the JAX package draws it from ``jax.random`` with
    that key; neither stream is numpy's), so with noise the images match
    the dataset's in distribution only.
    """

    def __init__(self, ds: AlignedSyntheticVLDataset, device):
        self.ds = ds
        self.device = torch.device(device)
        # fp32 tables, as the JAX package's renderer holds them (the numpy
        # dataset's basis is float64 under numpy's promotion rules)
        self.latents = torch.from_numpy(ds.latents).to(self.device, torch.float32)
        self.basis = torch.from_numpy(ds.basis).to(self.device, torch.float32)
        self.captions = torch.from_numpy(ds.captions).to(self.device)
        self.cap_lens = torch.from_numpy(ds.cap_lens).to(self.device)

    def render(self, classes: torch.Tensor, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """One batch for the (B,) class ids ``classes`` on the device."""
        ds = self.ds
        g = ds.grid
        coarse = torch.tanh(self.latents[classes] @ self.basis).reshape(-1, g, g, 3)
        rep = -(-ds.image_size // g)
        img = coarse.repeat_interleave(rep, dim=1).repeat_interleave(rep, dim=2)
        img = img[:, : ds.image_size, : ds.image_size, :]
        img = (img + 1.0) / 2.0
        if ds.noise:
            img = img + torch.randn(img.shape, generator=generator, device=self.device) * ds.noise
        img = torch.clamp(img, 0.0, 1.0)
        mask = (torch.arange(ds.text_len, device=self.device)[None, :]
                < self.cap_lens[classes][:, None]).to(torch.int32)
        return {"image": img, "input_ids": self.captions[classes] * mask, "attention_mask": mask}

    def batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        """The device batches, in the dataset's class schedule."""
        ds = self.ds
        rng = np.random.RandomState(ds.sample_seed + 7)
        gen = torch.Generator(device=self.device).manual_seed(ds.sample_seed + 13)
        for classes in ds.class_schedule(rng):
            yield self.render(torch.from_numpy(classes.astype(np.int64)).to(self.device), gen)


def hold_out_eval(batches, num_eval: int):
    """Split a batch iterator into (eval_batches, remaining_iterator): the
    first ``num_eval`` batches (fewer if the iterator ends) are a held-out
    eval set that training never sees."""
    it = iter(batches)
    held = []
    for _ in range(num_eval):
        try:
            held.append(next(it))
        except StopIteration:
            break
    return held, it
