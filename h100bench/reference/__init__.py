"""Plain PyTorch references that decide ``correct``. They import nothing
of the program and take nothing it made: the harness hands them the
weights and inputs it made from the seed, and the program's outputs only
to judge them. They compute in fp32 with TF32 off (``fp32``); ``precision``
"fp8" rounds every product's operands to fp8 e4m3, the control that the
comparison has to fail."""

import contextlib

import torch


@contextlib.contextmanager
def fp32():
    """Full fp32 products on the card: TF32 off for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
