"""forde_tpu_torch stands alone: importing every one of its modules loads
neither JAX (nor flax, orbax) nor any module of forde_tpu, and builds no
kernel."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import forde_tpu_torch
from forde_tpu_torch.kernels import build
names = ["forde_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(forde_tpu_torch.__path__, "forde_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
banned = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "forde_tpu")
)
print(json.dumps({"modules": names, "banned": banned, "built": sorted(build.build_log)}))
"""


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, check=True,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["banned"] == []
    assert result["built"] == []
    for name in (
        "forde_tpu_torch.core.config",
        "forde_tpu_torch.ops.attention_ref",
        "forde_tpu_torch.ops.flash_attention",
        "forde_tpu_torch.ops.stateful",
        "forde_tpu_torch.nn.stateful",
        "forde_tpu_torch.nn.transformer",
        "forde_tpu_torch.models.dual_encoder",
        "forde_tpu_torch.interop",
        "forde_tpu_torch.train.checkpoint",
        "forde_tpu_torch.embed",
        "forde_tpu_torch.kernels.build",
    ):
        assert name in result["modules"]


def test_every_kernel_source_is_found():
    from forde_tpu_torch.kernels import build

    assert sorted(p.stem for p in build.CSRC_DIR.glob("*.cu")) == ["flash_mha_fwd"]
    path = build.library_path("flash_mha_fwd")
    assert path.parent == REPO / "build" / "forde_tpu_torch"
    assert path.name.startswith("libflash_mha_fwd_") and path.suffix == ".so"
