"""No module the harness runs loads JAX, its libraries or the JAX
package; the check compares top-level names whole."""

import subprocess
import sys
from pathlib import Path

from h100bench import lookup, run

HARNESS = Path(run.__file__).resolve().parent


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["forde_tpu_torch", "forde_tpu_torch.ops", "jaxtyping",
                                  "flaxen", "torch"]) == []
    assert run.forbidden_modules(["jax.numpy", "forde_tpu.core", "optax"]) == [
        "forde_tpu", "jax", "optax"]


def test_every_harness_module_leaves_jax_unloaded():
    modules = sorted("h100bench." + ".".join(p.relative_to(HARNESS).with_suffix("").parts)
                     for p in HARNESS.rglob("*.py")
                     if "tests" not in p.parts and p.name != "conftest.py" and "." not in p.stem)
    metrics = sorted(p.stem for p in (HARNESS / "metrics").glob("*.py"))
    code = (
        "import importlib, sys\n"
        "from h100bench import lookup, run\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"for m in {metrics!r}: lookup.metric(m)\n"
        "import forde_tpu_torch.train.step, forde_tpu_torch.models.decode_pool\n"
        "print(run.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=lookup.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
