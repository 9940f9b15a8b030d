"""Rules the port keeps: it imports neither JAX nor the JAX package, it runs
without JAX installed, and its CUDA sources are built by a plain nvcc call
that this test can check without a compiler."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dist_svgd_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dist_svgd_torch"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "dist_svgd_tpu")]
    assert bad == []


def test_port_runs_with_jax_blocked():
    """A process where ``import jax`` fails imports the port and runs one
    CPU step of every exchange mode."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "import numpy as np, dist_svgd_torch as dt\n"
        "from dist_svgd_torch.utils.datasets import load_benchmark\n"
        "f = load_benchmark('banana', 42)\n"
        "p = np.random.default_rng(0).normal(size=(32, 3))\n"
        "for ep, es in ((True, False), (True, True), (False, False)):\n"
        "    ds = dt.DistSampler(4, dt.logreg_logp, None, p, data=(f.x_train, f.t_train),\n"
        "                        exchange_particles=ep, exchange_scores=es,\n"
        "                        include_wasserstein=False, device='cpu')\n"
        "    assert bool(ds.make_step(1e-2).isfinite().all())\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_sources_carry_their_notes_and_build_line():
    """Each kernel source says which TPU kernel it replaces, what bounds it
    and what the design does about it; the build compiles it for sm_90a
    without fast math."""
    for name, tpu_kernel in (("phi_small_d", "_phi_kernel_small_d"),
                             ("phi_big_d", "_phi_kernel")):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert f"Replaces: dist_svgd_tpu/ops/pallas_svgd.py, `{tpu_kernel}`" in text
        assert "What bounds it on this card" in text
        assert "What the design does about it" in text
        assert f'extern "C" int {name}_launch(' in text
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "fast_math" not in flags


def test_source_digest_names_each_library_by_content():
    digests = {n: _build.source_digest(n) for n in _build.SOURCES}
    assert len(set(digests.values())) == len(digests)
    assert all(len(v) == 16 for v in digests.values())
    assert _build.library_path("phi_big_d").name == f"libphi_big_d-{digests['phi_big_d']}.so"
    assert _build.BUILD_DIR == ROOT / "build" / "dist_svgd_torch"


def test_build_refuses_unknown_sources_and_missing_nvcc(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="unknown kernel sources"):
        _build.build(["phi_nope"])
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a system nvcc exists; the missing-compiler path cannot be shown")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
