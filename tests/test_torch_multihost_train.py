"""The port's multi-process training drill
(``dist_svgd_torch/tools/multihost_train.py``) against JAX's
``tools/multihost_train.py``, and ``utils/checkpoint.py:
split_state_for_processes`` against JAX's, on the CPU.

The fake drill's row has JAX's keys (read from JAX's source) and passes
every gate of its ``row_ok``; each broken gate fails it.  The per-process
split of a state is bitwise JAX's on the same dict, with JAX's refusals.
``FederationSupervisor`` runs over real worker subprocesses
(:class:`SubprocessWorker`): a SIGKILLed one is relaunched at W−1 and no
process outlives the run; a federation whose workers die past the restart
budget raises, so the drill's ``main`` exits non-zero.  The real kill-one
drill (2 → 1 gloo processes) is marked ``slow``, as JAX's is."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dist_svgd_tpu.utils import checkpoint as jckpt

from dist_svgd_torch.resilience import (
    FederationDead,
    FederationSupervisor,
    SubprocessWorker,
)
from dist_svgd_torch.telemetry import MetricsRegistry
from dist_svgd_torch.tools import multihost_train
from dist_svgd_torch.utils import checkpoint as ckpt

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _jax_row_keys(function: str) -> set:
    """The keys of the row JAX's ``tools/multihost_train.py:<function>``
    builds: its largest dict literal with a ``"metric"`` key (the other is
    the unsupported row)."""
    tree = ast.parse((ROOT / "tools" / "multihost_train.py").read_text())
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == function]
    rows = [n for n in ast.walk(fn) if isinstance(n, ast.Dict) and any(
        isinstance(k, ast.Constant) and k.value == "metric" for k in n.keys)]
    return {k.value for k in max(rows, key=lambda r: len(r.keys)).keys}


@pytest.fixture(scope="module")
def fake_row(tmp_path_factory):
    return multihost_train.run_drill(mode="fake", processes=4, devcount=2, n=48,
                                     num_steps=12, checkpoint_every=4, device="cpu",
                                     root=str(tmp_path_factory.mktemp("mh_drill")))


def test_fake_drill_row_has_jax_keys(fake_row):
    assert set(fake_row) == _jax_row_keys("_run_fake")
    assert fake_row["metric"] == "multihost_train" and fake_row["mode"] == "fake"
    assert fake_row["platform"] == "cpu"
    assert (fake_row["shards"], fake_row["shards_after_loss"]) == (8, 6)


def test_fake_drill_passes_all_its_gates(fake_row):
    ok, reasons = multihost_train.row_ok(fake_row)
    assert ok, reasons
    assert fake_row["resume_bitwise"] and fake_row["rng_layout_free"]
    assert fake_row["manifest_stamped"] and fake_row["single_block_rejected"]
    assert fake_row["steps_lost"] == fake_row["expected_steps_lost"] == 2
    assert fake_row["post_restart_recompiles"] == 0 and fake_row["sentry_supported"]
    assert fake_row["killone_within_tol"]


def test_fake_drill_federation_and_comm_profile(fake_row):
    assert fake_row["federation_restarts"] == 1
    assert fake_row["federation_final_processes"] == 3
    (tr,) = fake_row["federation_transitions"]
    assert (tr["from_processes"], tr["to_processes"]) == (4, 3)
    assert tr["restart_wall_s"] is not None
    # 8-shard gather ring: 7 hops a step; one process: no boundary crossed
    assert fake_row["ring_hops_per_step"] == 7
    assert fake_row["dcn_crossings_per_hop"] == 0
    assert fake_row["updates_per_s_gather"] > 0 and fake_row["updates_per_s_ring"] > 0


@pytest.mark.parametrize("key,bad", [
    ("resume_bitwise", False), ("rng_layout_free", False), ("manifest_stamped", False),
    ("single_block_rejected", False), ("variants_ok", False), ("steps_lost", 99),
    ("killone_within_tol", False), ("post_restart_recompiles", 3),
])
def test_row_ok_fails_on_each_broken_gate(fake_row, key, bad):
    ok, reasons = multihost_train.row_ok({**fake_row, key: bad})
    assert not ok and reasons


def test_row_ok_real_mode_gates():
    row = {"mode": "real", "status": "ok", "resume_t_complete": True,
           "federation_restarts": 1, "killone_within_tol": True}
    assert multihost_train.row_ok(row) == (True, [])
    for key, bad in (("resume_t_complete", False), ("federation_restarts", 0),
                     ("killone_within_tol", False)):
        assert not multihost_train.row_ok({**row, key: bad})[0], key
    ok, reasons = multihost_train.row_ok({"status": "unsupported",
                                          "unsupported_reason": "x"})
    assert ok and reasons == ["unsupported: x"]


def test_real_mode_refuses_nccl_with_more_ranks_than_cards(monkeypatch):
    """Two NCCL ranks on a one-card host are refused up front, naming
    backend="gloo", as JAX's drill refuses its legacy gap."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    row = multihost_train.run_drill(mode="real", processes=2, backend="nccl", device="cuda")
    assert row["status"] == "unsupported" and 'backend="gloo"' in row["unsupported_reason"]
    assert multihost_train.row_ok(row)[0]


# ---- per-process checkpoint split ------------------------------------- #


def _state(w2=True):
    ds = multihost_train.build_sampler(16, 8, include_w2=w2, device="cpu")
    ds.run_steps(2, 0.05)
    return ds.state_dict()


@pytest.mark.parametrize("w2", [False, True])
@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_split_state_for_processes_is_jax_bitwise(w2, W, tmp_path):
    state = _state(w2)
    ours = ckpt.split_state_for_processes(state, W)
    theirs = jckpt.split_state_for_processes(state, W)
    assert len(ours) == len(theirs) == W
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            assert (a[k] is None and b[k] is None) or np.array_equal(a[k], b[k]), k
    paths = [ckpt.save_state(str(tmp_path / f"rank_{r}"), blk) for r, blk in enumerate(ours)]
    full = ckpt.assemble_full_state(paths)
    for key, val in state.items():
        if key.endswith("_start") or key.startswith("topo_"):
            continue
        if val is None:
            assert full.get(key) is None
        else:
            np.testing.assert_array_equal(full[key], val, err_msg=key)
    man = ckpt.read_manifest(ours[0])
    assert man["process_count"] == W and man["granule_shards"].tolist() == [8 // W] * W


@pytest.mark.parametrize("case", ["three", "block", "manifest"])
def test_split_state_for_processes_refusals_match_jax(case):
    state = _state(False)
    if case == "three":
        args, match = (state, 3), "divide"
    elif case == "block":
        args, match = (ckpt.split_state_for_processes(state, 4)[1], 2), "per-process"
    else:
        args, match = ({"particles": np.zeros((8, 2))}, 2), "manifest"
    for mod in (ckpt, jckpt):
        with pytest.raises(ValueError, match=match):
            mod.split_state_for_processes(*args)


# ---- the coordinator over real worker processes ----------------------- #


def _popen(code: str):
    return subprocess.Popen([sys.executable, "-c", code])


def test_federation_supervisor_with_real_workers():
    """Generation 0: four sleeping workers, rank 1 SIGKILLed on its first
    poll; the supervisor drains the other three and relaunches three that
    exit 0.  Every process has ended when run() returns."""
    launched = []

    class KillOnPoll:
        def __init__(self, inner):
            self._inner, self.name = inner, inner.name

        def poll(self):
            self._inner.kill()
            return self._inner.poll()

        def kill(self):
            self._inner.kill()

        def wait(self, timeout_s=30.0):
            return self._inner.wait(timeout_s)

    def launcher(width, attempt):
        code = "import time; time.sleep(60)" if attempt == 0 else "pass"
        procs = [_popen(code) for _ in range(width)]
        launched.extend(procs)
        handles = [SubprocessWorker(f"rank{r}", p) for r, p in enumerate(procs)]
        if attempt == 0:
            handles[1] = KillOnPoll(handles[1])
        return handles

    reg = MetricsRegistry()
    try:
        report = FederationSupervisor(launcher, processes=4, restart_budget=1,
                                      poll_interval_s=0.05, registry=reg).run()
    finally:
        for p in launched:
            if p.poll() is None:
                p.kill()
    assert report["status"] == "ok" and report["processes"] == 3
    (tr,) = report["transitions"]
    assert (tr["from_processes"], tr["to_processes"]) == (4, 3)
    assert tr["lost"] == {"rank1": -9}
    assert all(p.poll() is not None for p in launched)
    assert reg.counter("svgd_elastic_federation_restarts_total").value() == 1


@pytest.fixture(scope="module")
def dying_drill(tmp_path_factory):
    """A real drill whose workers die: ``(exception, root)``."""
    root = tmp_path_factory.mktemp("mh_dying")
    try:
        multihost_train.run_drill(mode="real", processes=2, devcount=2, n=7, num_steps=4,
                                  checkpoint_every=2, device="cpu", root=str(root))
    except FederationDead as e:
        return e, root
    return None, root


def test_real_drill_whose_workers_die_raises(dying_drill):
    """Workers that die (n = 7 rows do not divide 4 shards) leave no
    survivors: the drill raises FederationDead, so its main exits
    non-zero — never a hang, never exit 0."""
    err, tmp_path = dying_drill
    assert isinstance(err, FederationDead) and "min_processes" in str(err)
    logs = sorted(tmp_path.glob("gen0_rank*.log"))
    assert len(logs) == 2 and all("not divisible" in p.read_text() for p in logs)


def test_main_exits_non_zero_on_a_failed_gate(monkeypatch, capsys):
    monkeypatch.setattr(multihost_train, "run_drill",
                        lambda **kw: {"mode": "real", "status": "ok",
                                      "resume_t_complete": True, "federation_restarts": 0,
                                      "killone_within_tol": True})
    assert multihost_train.main(["--device", "cpu"]) == 1
    assert '"ok": false' in capsys.readouterr().out


@pytest.mark.slow
def test_real_mode_kill_one_drill(tmp_path):
    """The real leg on the CPU: 2 gloo worker processes train, rank 1 takes
    a real SIGKILL after the first complete per-process save, and the
    supervisor relaunches the survivor with --resume."""
    row = multihost_train.run_drill(mode="real", processes=2, devcount=2, n=48, num_steps=8,
                                    checkpoint_every=4, device="cpu", root=str(tmp_path))
    ok, reasons = multihost_train.row_ok(row)
    assert ok, reasons
    assert row["federation_restarts"] == 1 and row["killone_within_tol"]
    assert row["backend"] == "gloo" and row["resumed_from"] == 4
    assert _jax_row_keys("_run_real") <= set(row)
