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


def _run_with_jax_blocked(code):
    """Run ``code`` in a fresh interpreter where ``import jax`` fails; it
    must print ``ok`` last.  One torch thread, as the in-process tests."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_no_jax_or_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert PORT / "tools" / "cuda_autotune.py" in files
    for module in ("serving/engine.py", "serving/batcher.py", "serving/registry.py",
                   "serving/server.py", "serving/__init__.py", "parallel/plan.py",
                   "telemetry/profile.py", "telemetry/usage.py", "tools/serve_bench.py",
                   "experiments/serve_covertype.py", "rollout/__init__.py",
                   "rollout/controller.py", "telemetry/history.py",
                   "tools/anomaly_report.py", "tools/workload_replay.py",
                   "tools/rollout_drill.py", "tools/cost_drill.py", "streaming/__init__.py",
                   "streaming/source.py", "streaming/pipeline.py",
                   "experiments/streaming_covertype.py", "tools/freshness_drill.py",
                   "serving/fleet.py", "tools/fleet_drill.py", "tools/fleet_status.py",
                   "tools/trace_report.py", "parallel/multihost.py",
                   "tools/multihost_worker.py", "tools/multihost_train.py"):
        assert PORT / module in files, module
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "dist_svgd_tpu", "tools")]
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
    _run_with_jax_blocked(code)


def test_multihost_runs_with_jax_blocked(tmp_path):
    """The process mesh, the drill's worker (one rank of a one-process gloo
    group on loopback) and the fake drill import and run where ``import
    jax`` fails."""
    code = (
        "import sys, json, socket; sys.modules['jax'] = None; "
        "sys.modules['dist_svgd_tpu'] = None\n"
        "from dist_svgd_torch.parallel import multihost\n"
        "from dist_svgd_torch.tools import multihost_train, multihost_worker\n"
        "s = socket.socket(); s.bind(('127.0.0.1', 0)); port = s.getsockname()[1]; s.close()\n"
        f"root = {str(tmp_path)!r}\n"
        "assert multihost_worker.main(['--rank', '0', '--nprocs', '1', '--coordinator',\n"
        "    f'127.0.0.1:{port}', '--root', root, '--n', '16', '--steps', '4',\n"
        "    '--checkpoint-every', '2', '--device', 'cpu']) == 0\n"
        "done = json.load(open(root + '/done_rank0.json'))\n"
        "assert done['t'] == 4 and done['backend'] == 'gloo'\n"
        "row = multihost_train.run_drill(mode='fake', processes=2, devcount=2, n=16,\n"
        "    num_steps=6, checkpoint_every=2, device='cpu', root=root + '/fake')\n"
        "assert multihost_train.row_ok(row)[0], row\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)


def test_serving_runs_with_jax_blocked():
    """The serving layer (engine, batcher, registry, server, profiler,
    usage meter, serve_bench) imports and serves one batch where ``import
    jax`` fails."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "import numpy as np\n"
        "from dist_svgd_torch import serving, telemetry\n"
        "from dist_svgd_torch.tools import serve_bench, trace_report\n"
        "from dist_svgd_torch.experiments import serve_covertype\n"
        "eng = serving.PredictiveEngine('logreg', np.ones((8, 3), np.float32), device='cpu')\n"
        "telemetry.enable_profiler(); telemetry.enable_usage()\n"
        "with serving.MicroBatcher(eng.predict) as bat:\n"
        "    assert bat.submit(np.ones((2, 2), np.float32)).result(10)['mean'].shape == (2,)\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)


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


@pytest.mark.parametrize("name,tpu_kernel", [
    ("ot_ctransform", "_ct_kernel"),
    ("ot_kexp", "_kexp_kernel"),
    ("ot_kmat_vec", "_kmat_vec_kernel"),
    ("ot_plan_grad", "_plan_grad_kernel"),
])
def test_ot_sources_carry_their_notes(name, tpu_kernel):
    """The Sinkhorn kernels carry the same note, name the Pallas kernel of
    dist_svgd_tpu/ops/pallas_ot.py they replace, and are built sources."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    assert f"Replaces: dist_svgd_tpu/ops/pallas_ot.py, `{tpu_kernel}`" in text
    assert "What bounds it on this card" in text
    assert "What the design does about it" in text
    assert f'extern "C" int {name}_launch(' in text
    assert '#include "ot_common.cuh"' in text
    assert name in _build.SOURCES


def test_streaming_runs_with_jax_blocked():
    """A process where ``import jax`` fails runs the streaming Covertype
    driver (stream, ring, supervisor, drift guard, hot reload) on the CPU,
    and imports the freshness drill."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "from dist_svgd_torch.experiments.streaming_covertype import run\n"
        "from dist_svgd_torch.tools import freshness_drill\n"
        "out = run(nrows=1000, nparticles=16, batch_rows=64, corpus_rows=128, batch_size=32,\n"
        "          steps_per_segment=2, refit_factor=2, segments=2, warmup_segments=2,\n"
        "          drift_at=0, device='cpu')\n"
        "assert out['stream']['segments'] == 4 and out['serve']['reloads'] == 4\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)


def test_fleet_runs_with_jax_blocked():
    """A process where ``import jax`` fails runs the fake fleet drill (at
    shrunk phases), stitches its exports, and imports the fleet status
    tool; no port module names ROADMAP A9 in a ``NotImplementedError``."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "from dist_svgd_torch.serving import FleetRouter, fleet\n"
        "from dist_svgd_torch.tools import fleet_drill, fleet_status, trace_report\n"
        "row = fleet_drill.run_drill('fake', steady_s=0.2, kill_s=0.3, partition_s=0.3)\n"
        "ok, why = fleet_drill.row_ok(row)\n"
        "assert ok, why\n"
        "assert row['trace_stitch_coverage'] == 1.0 and row['lost_requests'] == 0\n"
        "assert FleetRouter is fleet.FleetRouter\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)
    named = [str(f.relative_to(ROOT)) for f in sorted(PORT.rglob("*.py"))
             if "ROADMAP A9" in f.read_text()]
    assert named == []


def test_port_runs_w2_with_jax_blocked():
    """A process where ``import jax`` fails runs the port's W2 term: two CPU
    steps with the Sinkhorn solver (the first has no snapshot yet)."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "import numpy as np, dist_svgd_torch as dt\n"
        "p = np.random.default_rng(0).normal(size=(32, 3))\n"
        "x = np.random.default_rng(1).normal(size=(16, 2)); t = np.sign(x[:, 0])\n"
        "ds = dt.DistSampler(4, dt.logreg_logp, None, p, data=(x, t),\n"
        "                    wasserstein_solver='sinkhorn', device='cpu')\n"
        "out = ds.run_steps(2, 1e-2, h=10.0)\n"
        "assert bool(out.isfinite().all()) and ds.state_dict()['w2_g'].shape == (4, 32)\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)


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


def test_bf16x3_source_uses_the_tensor_cores():
    """The bf16x3 tier carries the same note, names the Pallas kernel it
    replaces, and computes its products with bf16 mma.sync on the tensor
    cores (no library GEMM)."""
    text = (_build.CSRC / "phi_big_d_bf16x3.cu").read_text()
    assert "Replaces: dist_svgd_tpu/ops/pallas_svgd.py, `_phi_kernel`" in text
    assert "What bounds it on this card" in text
    assert "What the design does about it" in text
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in text
    assert 'extern "C" int phi_big_d_bf16x3_launch(' in text
    assert "cublas" not in text.lower() and "phi_big_d_bf16x3" in _build.SOURCES
    small = (_build.CSRC / "phi_small_d.cu").read_text()
    assert 'extern "C" int phi_small_d_bf16_launch(' in small


def test_port_runs_the_covertype_driver_with_jax_blocked():
    """A process where ``import jax`` fails runs the Covertype driver (a
    minibatched, prior-separated, sharded-data run) on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "from dist_svgd_torch.experiments.covertype import run\n"
        "final, m = run(nrows=800, nproc=4, nparticles=16, niter=2, batch_size=32,\n"
        "               device='cpu')\n"
        "assert final.shape == (16, 55) and m['batch_size'] == 32\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)


@pytest.mark.parametrize("name,marker", [
    ("phi_wide_d", "fmaf("),
    ("phi_wide_d_bf16x3", "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16"),
])
def test_wide_d_sources_carry_their_notes(name, marker):
    """The two wide-d φ kernels carry the note, name the Pallas kernel they
    replace, are built sources, compute their products by hand (FP32 FMAs,
    bf16 wgmma) and call no library GEMM."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    assert "Replaces: dist_svgd_tpu/ops/pallas_svgd.py, `_phi_kernel`" in text
    assert "What bounds it on this card" in text
    assert "What the design does about it" in text
    assert f'extern "C" int {name}_launch(' in text
    assert marker in text and '#include "phi_common.cuh"' in text
    assert "cublas" not in text.lower() and "cudnn" not in text.lower()
    assert name in _build.SOURCES


def test_port_runs_the_bnn_driver_and_sampler_with_jax_blocked():
    """A process where ``import jax`` fails runs the BNN driver through the
    single-device Sampler with the per-step median bandwidth, and through
    two shards, on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "from dist_svgd_torch.experiments.bnn import run\n"
        "for nproc in (1, 2):\n"
        "    final, m = run(dataset='yacht', nproc=nproc, nparticles=8, n_hidden=4,\n"
        "                   niter=2, batch_size=16, bandwidth='median_step', device='cpu')\n"
        "    assert final.shape == (8, 35) and m['nproc'] == nproc\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)


def test_port_runs_the_autotune_tool_with_jax_blocked():
    """A process where ``import jax`` (and the JAX tool's package) fails runs
    the port's autotune tool on the CPU at a shrunk size, every mode."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "sys.modules['tools'] = None\n"
        "from dist_svgd_torch.tools import cuda_autotune as ct\n"
        "ct.K = ct.M = 64; ct.BIG_K, ct.BIG_M, ct.BIG_D = 16, 48, 10; ct.EXP_N = 32\n"
        "ct.HARVEST_SHAPES = [(1, 16, 40, 3)]; ct.GATE_RUNGS = (8, 16)\n"
        "ct.GATE_DIMS = {'CUDA_MIN_PAIRS': (3,), 'CUDA_MIN_PAIRS_BIG_D': (10,)}\n"
        "out = ct.main(['--device', 'cpu', '--iters', '2'])\n"
        "assert out['exp_share'] == out['exp_share']\n"
        "ct.main(['--device', 'cpu', '--iters', '2', '--big-d'])\n"
        "assert set(ct.main(['--device', 'cpu', '--harvest'])['gates']) == \\\n"
        "    {'CUDA_MIN_PAIRS', 'CUDA_MIN_PAIRS_BIG_D'}\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)


def test_small_d_source_carries_the_noexp_mode_and_its_note():
    """The no-exp probe is a mode of the small-d source, whose note names
    the JAX tool's kernel it replaces and why the ragged edge differs."""
    text = (_build.CSRC / "phi_small_d.cu").read_text()
    assert "Replaces: tools/pallas_autotune.py, `_noexp_kernel`" in text
    # K' = −min(d², D2_CAP) of t = −Σ_c diff², the exact tier's exponent chain
    assert "t = fmaf(-diff, diff, t);" in text and "fmaxf(t, -D2_CAP)" in text
    assert "constexpr float D2_CAP = 1e30f;" in text
    assert "_FAR" in text and "defined function on every shape" in text
    assert 'extern "C" int phi_small_d_noexp_launch(' in text
    assert "The no-exp probe does ~5d+3 f32 operations a pair" in text


def test_telemetry_and_approx_run_with_jax_blocked():
    """A process where ``import jax`` fails imports the port's telemetry
    (its diagnostics and SLOs too) and runs one CPU step
    of each approximate φ, with its residual gauges."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "import numpy as np, dist_svgd_torch as dt\n"
        "from dist_svgd_torch import telemetry\n"
        "from dist_svgd_torch.telemetry import diagnostics, slo\n"
        "p = np.random.default_rng(0).normal(size=(32, 2))\n"
        "lp = lambda th, _=None: -0.5 * (th * th).sum()\n"
        "tracer = telemetry.enable()\n"
        "for m in ('rff', 'nystrom'):\n"
        "    ds = dt.DistSampler(4, lp, None, p, include_wasserstein=False,\n"
        "                        kernel_approx=dt.KernelApprox(m, 16, 8), phi_impl='torch',\n"
        "                        device='cpu')\n"
        "    assert ds.kernel_approx_active and bool(ds.run_steps(1, 1e-2).isfinite().all())\n"
        "    assert ds.approx_residual(max_points=16)['n_eval'] == 16\n"
        "telemetry.disable()\n"
        "assert tracer.counts()['train.step_chunk'] == 2\n"
        "rep = telemetry.PosteriorDiagnostics().compute(p, scores=-p, num_shards=4)\n"
        "assert 'ksd' in rep and rep['ess'] > 1\n"
        "assert 'svgd_diag_phi_approx_rel_err' in telemetry.default_registry().exposition()\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)


def test_resilience_and_fault_drill_run_with_jax_blocked():
    """A process where ``import jax`` (and JAX's tools) fails runs a
    supervised GMM run preempted and resumed bitwise, and the port's fault
    drill at a shrunk size, on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "sys.modules['tools'] = None\n"
        "import tempfile, numpy as np, torch, dist_svgd_torch as dt\n"
        "from dist_svgd_torch.models.gmm import gmm_logp\n"
        "from dist_svgd_torch.resilience import FaultPlan, PreemptAt, RunSupervisor\n"
        "from dist_svgd_torch.tools import fault_drill\n"
        "root = tempfile.mkdtemp()\n"
        "p = np.random.default_rng(0).normal(size=(32, 2))\n"
        "def sup(name, **kw):\n"
        "    ds = dt.DistSampler(4, lambda th, _=None: gmm_logp(th), None, p,\n"
        "                        exchange_scores=False, include_wasserstein=False, device='cpu')\n"
        "    return RunSupervisor(ds, 8, 0.05, checkpoint_dir=f'{root}/{name}',\n"
        "                         checkpoint_every=4, segment_steps=2, **kw)\n"
        "ref = sup('ref'); ref.run()\n"
        "assert sup('k', faults=FaultPlan(PreemptAt(3))).run()['status'] == 'preempted'\n"
        "res = sup('k'); r = res.run(resume=True)\n"
        "assert r['resumed_from'] == 4 and torch.equal(ref.particles, res.particles)\n"
        "row = fault_drill.run_drill(n=64, num_shards=2, num_steps=12, checkpoint_every=4,\n"
        "                            segment_steps=2, root=f'{root}/drill',\n"
        "                            diag_overhead=False, device='cpu')\n"
        "assert row['resumed_bitwise_identical'] and row['nan_rollback_recovered']\n"
        "assert row['retry_backoff_recovered']\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)


def test_rollout_history_and_drills_run_with_jax_blocked():
    """A process where ``import jax`` (and JAX's tools) fails walks a
    candidate through a rollout on a manual clock, records a history ring,
    reads it back through the anomaly report and ``trace_report
    --programs``, replays a seeded trace, and runs the cost drill at a
    shrunk size, on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "sys.modules['tools'] = None\n"
        "import tempfile, numpy as np\n"
        "from dist_svgd_torch.rollout import RolloutController, RolloutPlan\n"
        "from dist_svgd_torch.serving import PredictiveEngine\n"
        "from dist_svgd_torch.telemetry import HistoryRecorder, MetricsRegistry\n"
        "from dist_svgd_torch.tools import (anomaly_report, cost_drill, rollout_drill,\n"
        "                                   trace_report, workload_replay)\n"
        "p = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)\n"
        "eng = PredictiveEngine('logreg', p, min_bucket=4, max_bucket=4, device='cpu')\n"
        "t = [0.0]\n"
        "ro = RolloutController(eng, clock=lambda: t[0], plan=RolloutPlan(\n"
        "    shadow_min_mirrors=1, shadow_hold_s=0.0, canary_stages=(1.0,),\n"
        "    stage_hold_s=0.0, stage_min_requests=1))\n"
        "assert ro.offer(p + np.float32(1e-3))\n"
        "eng.registry.histogram('svgd_rollout_divergence').observe(1e-4)\n"
        "assert ro.step()['action'] == 'advance'\n"
        "eng.registry.histogram('svgd_serve_request_latency_seconds').observe(\n"
        "    1e-3, generation='candidate')\n"
        "assert ro.step()['action'] == 'promote' and eng.stats()['generation_id'] == 2\n"
        "ro.close()\n"
        "root = tempfile.mkdtemp()\n"
        "rec = HistoryRecorder(MetricsRegistry(), root, clock=lambda: 0.0)\n"
        "rec.registry.counter('svgd_x_total', 'x').inc(3); rec.record_once()\n"
        "assert anomaly_report.main([root]) == 0\n"
        "assert trace_report.main(['--programs', root]) == 0\n"
        "ev = workload_replay.generate_trace(workload_replay.TraceConfig(duration_s=1.0))\n"
        "assert len(ev) > 0\n"
        "row = cost_drill.run_drill(tenants=(('a', 32),), n_features=4, max_batch=4,\n"
        "                           requests=4, ab_rounds=0, history_windows=1,\n"
        "                           device='cpu')\n"
        "assert row['tenant_sum_err_frac'] < 0.01 and row['history_records'] == 2\n"
        "assert callable(rollout_drill.run_drill)\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)


def test_autoscale_storm_and_elastic_drill_run_with_jax_blocked():
    """A process where ``import jax`` (and JAX's tools) fails steps the
    autoscale controller to a scale-up on a manual clock, runs the storm's
    helpers and a two-tenant adaptive-only storm of a few seconds with the
    settle pauses at 0, and the elastic drill at a shrunk size, on the
    CPU."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "sys.modules['tools'] = None\n"
        "import tempfile, numpy as np\n"
        "from dist_svgd_torch.serving import AutoscaleController, AutoscalePolicy, MicroBatcher\n"
        "from dist_svgd_torch.telemetry import MetricsRegistry\n"
        "from dist_svgd_torch.tools import elastic_drill, workload_replay as wr\n"
        "reg = MetricsRegistry()\n"
        "bat = MicroBatcher(lambda x: {'y': x}, max_batch=8, max_queue_rows=64,\n"
        "                   registry=reg, autostart=False)\n"
        "t = [0.0]\n"
        "c = AutoscaleController(bat, metrics=reg, clock=lambda: t[0],\n"
        "                        policy=AutoscalePolicy(p99_target_ms=10.0))\n"
        "h = reg.histogram('svgd_serve_request_latency_seconds', 't')\n"
        "for _ in range(50): h.observe(0.5)\n"
        "t[0] += 2.0\n"
        "assert c.step()['actions'] == ['lanes 1->2', 'max_wait_ms 2->4']\n"
        "bat.start(); bat.close(drain=True)\n"
        "assert wr.storm_ok({'lost_requests': 1})[0] is False\n"
        "assert 1 <= wr.default_lanes_max() <= 4\n"
        "for k in ('WARM_SETTLE_S', 'PROBE_GAP_S', 'PROBE_SETTLE_S', 'ARM_SETTLE_S'):\n"
        "    setattr(wr, k, 0.0)\n"
        "row = wr.run_storm(n_particles=64, n_features=4, steady_s=0.3, burst_s=0.3,\n"
        "                   recover_s=0.3, max_batch=16, max_queue_rows=64,\n"
        "                   rows_sizes=(1, 2), flash_rows_sizes=(8,), tenants=2,\n"
        "                   calib_requests=60, interval_s=0.1, include_static=False,\n"
        "                   device='cpu')\n"
        "assert wr.storm_ok(row)[0] and row['sentry_compiles'] == 0\n"
        "d = elastic_drill.run_drill(n=32, shards_from=4, shards_to=2, num_steps=12,\n"
        "                            checkpoint_every=4, segment_steps=2, shards_grow_from=2,\n"
        "                            root=tempfile.mkdtemp(), device='cpu')\n"
        "assert elastic_drill.drill_ok(d), d\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)


def test_bench_suite_and_perf_regress_run_with_jax_blocked():
    """The bench suite and the regression gate import where ``import jax``
    fails: one suite config and the gate's chained rows at a tiny size on
    the CPU, ``--list-missing``, and the committed sklearn targets read
    without sklearn."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "sys.modules['sklearn'] = None\n"
        "import argparse, io, contextlib\n"
        "from dist_svgd_torch.experiments import bench_suite as bs\n"
        "from dist_svgd_torch.tools import perf_regress as pr\n"
        "bs.CHAIN.update(samples=1, target_s=0.01)\n"
        "row = bs.bench_logreg_sharded(1, num_shards=2, n_particles=8, device='cpu')\n"
        "assert row['emulated'] and row['updates_per_sec'] > 0\n"
        "assert bs.acceptance_targets()['covertype']['n_rows'] == 50000\n"
        "b = pr.build_benches('cpu', n=16, w2_streaming_n=32, covertype_rows=2048,\n"
        "                     config1_n=8, steps=dict(north_star=1, w2_warm=1, covertype=1,\n"
        "                     w2_streaming=1, config1=1, phi_sweeps=1))\n"
        "best, reps, sentry = pr.measure_chained(b, 1, 0.001)\n"
        "rows, fails, res = pr.chained_rows(b, best, reps, sentry, {},\n"
        "                                   argparse.Namespace(tol=0.35, rounds=1))\n"
        "assert fails == 0 and len(res) == 6\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert pr.main(['--list-missing']) == 0\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)


def test_package_data_ships_the_ports_data_files():
    """Every non-Python file the port reads at run time (CUDA sources, the
    committed incumbents, program cards and acceptance targets) matches a
    ``package-data`` pattern of ``pyproject.toml``."""
    import fnmatch
    import tomllib

    patterns = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"][
        "package-data"]["dist_svgd_torch"]
    files = [p.relative_to(PORT).as_posix() for p in PORT.rglob("*")
             if p.suffix in (".cu", ".cuh", ".json")]
    assert {"tools/perf_incumbents.json", "tools/program_cards.json",
            "experiments/acceptance_targets.json"} <= set(files)
    for f in files:
        assert any(fnmatch.fnmatch(f, pat) for pat in patterns), f
