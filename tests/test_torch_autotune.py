"""The port's autotune tool (``python -m dist_svgd_torch.tools.cuda_autotune``,
the port of ``tools/pallas_autotune.py``) on the CPU at shrunk shapes: every
mode runs and prints its rows, ``--harvest`` ends with the two gate lines,
the f64 oracle is JAX's, and the tool refuses to run without CUDA unless
asked for the CPU."""

import re

import numpy as np
import pytest
import torch

from tools.pallas_autotune import f64_oracle_phi as jf64_oracle_phi

from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.tools import cuda_autotune as tool
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def small(monkeypatch):
    """The tool's shapes and ladders shrunk to a CPU size."""
    monkeypatch.setattr(tool, "K", 120)
    monkeypatch.setattr(tool, "M", 200)
    monkeypatch.setattr(tool, "BIG_K", 40)
    monkeypatch.setattr(tool, "BIG_M", 150)
    monkeypatch.setattr(tool, "BIG_D", 12)
    monkeypatch.setattr(tool, "EXP_N", 64)
    monkeypatch.setattr(tool, "HARVEST_SHAPES", [(1, 30, 100, 3), (2, 20, 50, 12),
                                                 (1, 10, 20, 140)])
    monkeypatch.setattr(tool, "GATE_RUNGS", (8, 16))


def test_default_mode_prints_sweep_ablation_and_budgets(small, capsys):
    out = tool.main(["--device", "cpu", "--iters", "2"])
    text = capsys.readouterr().out
    assert text.startswith("device: cpu")
    assert "exp roofline f32" in text and "GB/s" in text and "exp roofline bf16" in text
    assert "torch φ" in text
    for bps in tool.SPLIT_LADDER:
        assert f"small-d kernel {bps:2d} blocks/SM" in text
    assert "exp share" in text and "φ bf16-exp" in text
    assert np.isfinite(out["exp_share"])
    assert set(out["sweep_ms"]) == {"torch", *map(str, tool.SPLIT_LADDER)}
    # the plain versions' own distance from the f64 φ
    assert out["f32_err"] < 1e-5 and out["bf16_err"] < 1e-2


def test_skip_sweep_times_the_ablation_only(small, capsys):
    out = tool.main(["--device", "cpu", "--iters", "2", "--skip-sweep"])
    text = capsys.readouterr().out
    assert "exp roofline" not in text and "blocks/SM" not in text
    assert {"full_ms", "noexp_ms", "bf16_ms", "exp_share"} <= set(out)


def test_big_d_mode_times_both_tiers_and_the_torch_phi(small, capsys):
    out = tool.main(["--device", "cpu", "--iters", "2", "--big-d"])
    text = capsys.readouterr().out
    assert "big-d φ at (40, 150, 12), h=24.0" in text
    assert set(out["ms"]) == {"phi_big_d (exact f32)", "phi_big_d_bf16x3 (bf16x3)", "torch φ"}
    assert out["f32_err"] < 1e-5 and out["bf16x3_err"] < 1e-2


def test_harvest_ends_with_the_two_gate_lines(small, capsys):
    out = tool.main(["--device", "cpu", "--harvest"])
    lines = capsys.readouterr().out.strip().splitlines()
    gates = {}
    for line in lines[-2:]:
        m = re.fullmatch(r"(CUDA_MIN_PAIRS(?:_BIG_D)?) = (?:0|1 << (\d+))", line)
        assert m, line
        gates[m.group(1)] = 1 << int(m.group(2)) if m.group(2) else 0
    assert gates == out["gates"]
    # each gate is 0, a rung of the ladder (S = 1, n² pairs) or the power
    # of two above it
    assert all(v in (0, 64, 256, 512) for v in gates.values())
    assert set(out["ladders"]) == {3, 55, 753}
    assert len(out["splits"]) == 3


@pytest.mark.parametrize("kernel_ms,torch_ms,want", [
    ((5, 4, 3, 2), (6, 5, 4, 3), (0, None)),    # wins at every rung: no gate
    ((7, 6, 3, 2), (6, 5, 4, 3), (256, None)),  # loses at small rungs, wins from the third
    ((1, 2, 3, 9), (6, 5, 4, 3), (0, 512)),     # wins small, loses the last: no gate
    ((7, 6, 5, 9), (6, 5, 4, 3), (1024, None)), # loses everywhere: above the ladder
    ((7, 4, 3, 2), (6, 5, 4, 3), (128, None)),
    ((7, 4, 5, 2), (6, 5, 4, 3), (512, None)),  # the last run of wins sets the line
    ((7, 2, 3, 9), (6, 5, 4, 3), (128, 512)),
])
def test_crossover_rule(kernel_ms, torch_ms, want):
    rungs = [64, 128, 256, 512]
    assert tool.crossover(rungs, dict(zip(rungs, kernel_ms)),
                          dict(zip(rungs, torch_ms))) == want


def test_crossover_rounds_down_to_a_power_of_two():
    rungs = [100, 400]
    assert tool.crossover(rungs, {100: 2, 400: 1}, {100: 1, 400: 2}) == (256, None)
    assert [tool.gate_line("CUDA_MIN_PAIRS", p) for p in (0, 256)] == [
        "CUDA_MIN_PAIRS = 0", "CUDA_MIN_PAIRS = 1 << 8"]


def test_f64_oracle_is_jax_bitwise():
    rng = np.random.default_rng(4)
    y, x, s = rng.normal(size=(17, 5)), rng.normal(size=(23, 5)), rng.normal(size=(23, 5))
    for h in (1.0, 7.5):
        np.testing.assert_array_equal(tool.f64_oracle_phi(y, x, s, h),
                                      jf64_oracle_phi(y, x, s, h))
    f32 = [a.astype(np.float32) for a in (y, x, s)]
    np.testing.assert_array_equal(tool.f64_oracle_phi(*f32), jf64_oracle_phi(*f32))


def test_device_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--skip-sweep"])


def test_run_kernel_takes_plain_versions_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(1)
    y = torch.tensor(rng.normal(size=(2, 9, 3)), dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(11, 3)), dtype=torch.float32)
    s = torch.tensor(rng.normal(size=(2, 11, 3)), dtype=torch.float32)
    cuda_svgd.reset_launch_counts()
    for name, plain in (("phi_small_d", cuda_svgd.phi_small_d_plain),
                        ("phi_small_d_bf16", cuda_svgd.phi_small_d_bf16_plain)):
        torch.testing.assert_close(cuda_svgd.launch(name, y, x, s, 2.0, 4),
                                   plain(y, x, s, 2.0), rtol=0, atol=0)
    torch.testing.assert_close(cuda_svgd.launch("phi_small_d_noexp", y, x, s),
                               cuda_svgd.phi_small_d_noexp_plain(y, x, s), rtol=0, atol=0)
    assert sum(cuda_svgd.launch_counts.values()) == 0
    assert cuda_svgd.kernel_for(3) == "phi_small_d" and cuda_svgd.kernel_for(55, "bf16") == \
        "phi_big_d_bf16x3" and cuda_svgd.kernel_for(753) == "phi_wide_d"
    assert cuda_svgd.plain_of("phi_wide_d_bf16x3") is cuda_svgd.phi_big_d_bf16x3_plain
