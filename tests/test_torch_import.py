"""The PyTorch port stays free of JAX."""

import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "smooth_feedback_tpu_torch"
EXAMPLES = ROOT / "examples_torch"


def _modules():
    for path in sorted([*PKG.rglob("*.py"), *EXAMPLES.glob("*.py")]):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_without_jax():
    """Every port module imports in a fresh interpreter from the repository
    root (no install assumed) and leaves jax out of sys.modules; importing
    builds nothing."""
    mods = list(_modules())
    for m in ("qp.cuda_kernel", "groups._series", "groups.groups", "controllers.mpc",
              "controllers.asif", "controllers.pid", "estimators", "estimators.ekf",
              "utils.compensated", "utils.bounds", "utils.linalg", "utils.spline", "nlp",
              "ocp.nlp", "ocp.flatten", "ocp.to_nlp", "ocp.solve", "ocp.collocation.functions",
              "solvers", "solvers.sqp", "compat", "compat.scipy_nlp", "compat.osqp_bridge",
              "compat.ipopt_bridge", "utils.flops"):
        assert f"smooth_feedback_tpu_torch.{m}" in mods
    assert len([m for m in mods if m.startswith("examples_torch.")]) >= 13
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "from smooth_feedback_tpu_torch import _build\n"
        "assert _build._lib is None\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=str(ROOT), timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_source_has_no_jax_import():
    """No source file of the port or of its examples imports jax or the
    JAX package, at top level or lazily."""
    pat = re.compile(r"^\s*(import jax|from jax|import smooth_feedback_tpu\b(?!_torch)"
                     r"|from smooth_feedback_tpu\b(?!_torch))", re.M)
    hits = [str(p) for p in [*PKG.rglob("*.py"), *EXAMPLES.glob("*.py")] if pat.search(p.read_text())]
    assert not hits, hits
