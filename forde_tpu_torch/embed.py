"""Embedding / retrieval CLI for the FORDE dual encoder
(port of forde_tpu/embed.py).

Loads a checkpoint directory (``model_config.json`` + ``params.npz``,
train/checkpoint.py), embeds images and/or token sequences with
``FORDEDualEncoder.encode_image`` / ``encode_text`` and prints the
cosine-similarity matrix. Runs on CUDA unless ``--device cpu``; with no
GPU visible it raises.

  python -m forde_tpu_torch.embed --checkpoint_dir ckpt \\
      --image_npy img0.npy,img1.npy --text_ids "12,99,407;7,5"
  python -m forde_tpu_torch.embed --checkpoint_dir ckpt \\
      --image_npy img.npy --out emb   # writes emb_image.npy/emb_text.npy
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from forde_tpu_torch import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FORDE dual-encoder embedding")
    p.add_argument("--checkpoint_dir", type=str, required=True,
                   help="checkpoint dir (model_config.json + params.npz)")
    p.add_argument("--image_npy", type=str, default=None,
                   help="comma-separated .npy image paths, each (H, W, 3) "
                        "float [0,1] or uint8 (resized, antialiased "
                        "bilinear, if the size differs)")
    p.add_argument("--text_ids", type=str, default=None,
                   help="semicolon-separated token-id sequences, e.g. "
                        '"12,99,407;7,5" (padded/truncated to max_text_len)')
    p.add_argument("--use_ema", action="store_true",
                   help="embed with the EMA weights (not ported yet)")
    p.add_argument("--out", type=str, default=None,
                   help="prefix: saves <out>_image.npy / <out>_text.npy")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def resize_bilinear(image: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) -> (size, size, C): bilinear with antialiasing when
    shrinking, the arithmetic of ``jax.image.resize(..., "bilinear")``."""
    x = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    x = x.permute(2, 0, 1)[None]
    y = F.interpolate(
        x, size=(size, size), mode="bilinear", antialias=True, align_corners=False
    )
    return y[0].permute(1, 2, 0).numpy()


def _load_images(paths: str, size: int) -> np.ndarray:
    imgs = []
    for path in paths.split(","):
        arr = np.load(path.strip())
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f"{path}: expected (H, W, 3), got {arr.shape}")
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        arr = arr.astype(np.float32)
        if arr.shape[:2] != (size, size):
            arr = resize_bilinear(arr, size)
        imgs.append(arr)
    return np.stack(imgs)


def _load_texts(spec: str, max_len: int, pad_id: int = 0):
    ids, mask = [], []
    for seq in spec.split(";"):
        toks = [int(t) for t in seq.split(",") if t.strip()][:max_len]
        ids.append(toks + [pad_id] * (max_len - len(toks)))
        mask.append([1] * len(toks) + [0] * (max_len - len(toks)))
    return np.asarray(ids, np.int32), np.asarray(mask, np.int32)


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    if not (args.image_npy or args.text_ids):
        raise SystemExit("give --image_npy and/or --text_ids")
    if args.use_ema:
        raise NotImplementedError("--use_ema: EMA weights are not ported yet")
    device = resolve_device(args.device)
    from forde_tpu_torch.models.dual_encoder import l2_normalize
    from forde_tpu_torch.train.checkpoint import load_meta, load_clip_params

    cfg, model = load_clip_params(args.checkpoint_dir, device)
    step = int(load_meta(args.checkpoint_dir)[1].get("step", 0))
    print(f"[embed] restored step {step} from {args.checkpoint_dir}")

    img_emb = txt_emb = None
    with torch.inference_mode():
        if args.image_npy:
            images = torch.from_numpy(_load_images(args.image_npy, cfg.image_size))
            img_emb = model.encode_image(images.to(device))
            print(f"[embed] {img_emb.shape[0]} image embeddings, "
                  f"dim {img_emb.shape[1]}")
        if args.text_ids:
            ids, mask = _load_texts(args.text_ids, cfg.max_text_len)
            txt_emb = model.encode_text(
                torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
            )
            print(f"[embed] {txt_emb.shape[0]} text embeddings, "
                  f"dim {txt_emb.shape[1]}")
        if img_emb is not None and txt_emb is not None:
            sim = (l2_normalize(img_emb) @ l2_normalize(txt_emb).T).cpu().numpy()
            print("[embed] image x text cosine similarity:")
            for row in sim:
                print("  " + " ".join(f"{v:+.4f}" for v in row))
            print("[embed] best text per image:", sim.argmax(-1).tolist())
    if args.out:
        if img_emb is not None:
            np.save(f"{args.out}_image.npy", img_emb.cpu().numpy())
        if txt_emb is not None:
            np.save(f"{args.out}_text.npy", txt_emb.cpu().numpy())
        print(f"[embed] saved under prefix {args.out}")


if __name__ == "__main__":
    main()
