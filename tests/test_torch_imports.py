"""forde_tpu_torch stands alone: importing every one of its modules loads
neither JAX (nor flax, optax, orbax) nor any module of forde_tpu, nor
scripts/orbax_to_npz.py (the one file beside the package that converts
JAX checkpoints, and imports JAX), nor matplotlib (obs/plots.py imports it
at its first plot), and builds no kernel."""

import ast
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
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "forde_tpu",
                           "orbax_to_npz", "scripts", "matplotlib")
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
        "forde_tpu_torch.ops.stat_sums",
        "forde_tpu_torch.ops.gmm",
        "forde_tpu_torch.brain.sensing",
        "forde_tpu_torch.brain.clustering",
        "forde_tpu_torch.brain.smoothing",
        "forde_tpu_torch.brain.neuron_slow_loop",
        "forde_tpu_torch.data.vl",
        "forde_tpu_torch.data.prefetch",
        "forde_tpu_torch.obs.metrics",
        "forde_tpu_torch.train.optim",
        "forde_tpu_torch.train.state",
        "forde_tpu_torch.train.clip_step",
        "forde_tpu_torch.train.clip_loop",
        "forde_tpu_torch.ops.nsa_attention",
        "forde_tpu_torch.ops.sinkhorn",
        "forde_tpu_torch.ops.moe_dispatch",
        "forde_tpu_torch.nn.hyper_connections",
        "forde_tpu_torch.nn.moe",
        "forde_tpu_torch.nn.attention",
        "forde_tpu_torch.models.decoder_lm",
        "forde_tpu_torch.models.generate",
        "forde_tpu_torch.serve",
        "forde_tpu_torch.brain.actuation",
        "forde_tpu_torch.brain.slow_loop",
        "forde_tpu_torch.data.lm",
        "forde_tpu_torch.train.step",
        "forde_tpu_torch.train.loop",
        "forde_tpu_torch.core.graphs",
        "forde_tpu_torch.ops.topk_replay",
        "forde_tpu_torch.ops.quant",
        "forde_tpu_torch.models.speculative",
        "forde_tpu_torch.models.decode_pool",
        "forde_tpu_torch.serve_http",
        "forde_tpu_torch.train.ema",
        "forde_tpu_torch.train.lora",
        "forde_tpu_torch.train.distill",
        "forde_tpu_torch.eval_lm",
        "forde_tpu_torch.obs.retrieval",
        "forde_tpu_torch.nn.nsa_modules",
        "forde_tpu_torch.nn.remat",
        "forde_tpu_torch.obs.plots",
        "forde_tpu_torch.obs.profiler",
    ):
        assert name in result["modules"]


def test_no_module_imports_the_converter_or_jax():
    """No import statement of the package names the converter script, JAX
    or the JAX package (the probe above sees only what an import runs;
    this reads every statement, those inside functions too)."""
    for path in sorted((REPO / "forde_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "flax", "optax", "orbax", "forde_tpu", "orbax_to_npz", "scripts",
                ), (path, name)


def test_every_kernel_source_is_found():
    from forde_tpu_torch.kernels import build

    assert sorted(p.stem for p in build.CSRC_DIR.glob("*.cu")) == [
        "flash_bwd", "flash_fwd", "flash_mha_bwd", "flash_mha_fwd", "moment_sums",
        "small_kv_bwd", "small_kv_fwd", "topk_replay",
    ]
    path = build.library_path("flash_mha_fwd")
    assert path.parent == REPO / "build" / "forde_tpu_torch"
    assert path.name.startswith("libflash_mha_fwd_") and path.suffix == ".so"



def test_kernel_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """A changed csrc/common.cuh renames (and so rebuilds) every kernel
    library; a changed kernel source renames only its own."""
    import shutil

    from forde_tpu_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    names = ("flash_mha_bwd", "flash_mha_fwd", "moment_sums")
    before = {n: build.library_path(n) for n in names}
    with open(csrc / "moment_sums.cu", "a") as f:
        f.write("// edit\n")
    after_kernel = {n: build.library_path(n) for n in names}
    assert [n for n in names if after_kernel[n] != before[n]] == ["moment_sums"]
    with open(csrc / "common.cuh", "a") as f:
        f.write("// edit\n")
    assert all(build.library_path(n) != after_kernel[n] for n in names)
