"""Two NCCL ranks on one card: does NCCL take them?

Every rank of this script sets the same card (cuda:0), starts NCCL and
all-reduces a small tensor; each prints what it got, or the error NCCL
raised. Run it on a machine with one GPU:

  torchrun --standalone --nproc_per_node 2 scripts/nccl_one_card.py

The multi-device tests therefore run n ranks as threads of one process
on one card (forde_tpu_torch/parallel/collectives.run_threads), and the
CLIs under NCCL with one rank per card.
"""

import os
import sys

import torch
import torch.distributed as dist

rank = int(os.environ["RANK"])
torch.cuda.set_device(0)
dist.init_process_group("nccl")
try:
    x = torch.full((4,), float(rank + 1), device="cuda:0")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print(f"rank {rank}: all_reduce on one card gave {x.tolist()}", flush=True)
    code = 0
except Exception as err:  # noqa: BLE001 - the finding is the error itself
    print(f"rank {rank}: {type(err).__name__}: {err}", flush=True)
    code = 3
finally:
    dist.destroy_process_group()
sys.exit(code)
