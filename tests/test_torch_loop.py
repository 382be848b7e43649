"""The whole first port slice on the CPU: capture -> wall-clock tune ->
wisdom -> relaunch, the MicroHH loop, and captures written by the JAX package
replayed by the port. On the CPU every launch runs the plain PyTorch version,
so these tests check the loop's control flow and its agreement with the
reference; the kernels and their times are checked on the card by
``chip_smoke.py``."""

from __future__ import annotations

import glob
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.kernels import ref as repro_ref

import repro_torch.core as pc
from repro_torch.examples import quickstart, tune_microhh
from repro_torch.kernels._build import KernelBuildError
from repro_torch.tuner import WallClockEvaluator, tune_capture, tune_kernel
from repro_torch.tuner import tune as tune_cli

REPO = Path(__file__).resolve().parent.parent

# The tensors here are small: one intra-op thread keeps these tests off
# the cores that parallel test workers need.
torch.set_num_threads(1)
SCAL = np.array([[1.1, 0.9, 1.3, 0.0]], np.float32)


def test_quickstart_on_cpu_matches_repro(capsys):
    out = quickstart.main(["--device", "cpu", "--m", "64", "--k", "96",
                           "--n", "32", "--max-evals", "3"])
    assert out["tiers"] == ("default", "exact")
    assert "launch #2: tier=exact" in capsys.readouterr().out
    want = repro_ref.matmul_ref(out["a"].numpy(), out["b"].numpy())
    np.testing.assert_allclose(out["c2"].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    assert torch.equal(out["c"], out["c2"])


def test_tune_microhh_on_cpu_smoke_grids(tmp_path):
    out = tune_microhh.main(["--device", "cpu", "--smoke", "--max-evals", "2",
                             "--wisdom-dir", str(tmp_path)])
    assert len(out["tuned"]) == 4
    assert all(res.best_config is not None for _, res in out["tuned"])
    assert [tier for _, tier, _ in out["selected"]] == ["exact"] * 4
    assert [st.tier for _, _, st, _ in out["launched"]] == \
        ["device+dtype"] * 4
    # the port's wisdom files load in the reference
    for kernel in ("advec_u", "diff_uvw"):
        w = rc.Wisdom.load(kernel, tmp_path)
        assert {r.dtype for r in w.records} == {"float32", "bfloat16"}
        assert {r.device_kind for r in w.records} == {"cpu"}


def _repro_args(kernel, dtype, rng):
    def arr(shape, square=False):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(x ** 2 if square else x, dtype))

    if kernel == "matmul":
        return [arr((64, 48)), arr((48, 32))]
    shape = (8, 16, 32)
    fields = [arr(shape) for _ in range(3)]
    if kernel == "diff_uvw":
        fields.append(arr(shape, square=True))
    return fields + [SCAL]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["advec_u", "diff_uvw", "matmul"])
def test_repro_capture_replays_in_port(tmp_path, rng, kernel, dtype):
    args = _repro_args(kernel, dtype, rng)
    rb = rc.get_kernel(kernel)
    problem = rb.get_problem_size(*args)
    path = rc.write_capture(kernel, problem, dtype, args, tmp_path / "cap")
    cap = pc.load_capture(path)
    assert (cap.kernel_name, cap.problem_size, cap.dtype) == (
        kernel, tuple(problem), dtype)
    for got, want in zip(cap.args, args):
        bits = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        assert bits.numpy().tobytes() == want.tobytes()
    # the port's plain version on the replayed tensors == the reference's
    got = pc.get_kernel(kernel).make_reference()(*cap.args)
    want = rb.make_reference()(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g.to(torch.float64).numpy(), w, rtol=tol,
                                   atol=tol * max(1.0, np.abs(w).max()))
    res = tune_capture(path, "cpu", strategy="random", max_evals=2,
                       wisdom_dir=tmp_path / "w", device="cpu")
    assert res.best_config is not None
    rec, tier = pc.Wisdom.load(kernel, tmp_path / "w").select_record(
        "cpu", problem, dtype)
    assert tier == "exact" and rec.config == res.best_config


def test_tune_cli_replays_port_captures(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(pc.CAPTURE_ENV, "matmul")
    monkeypatch.setenv("KERNEL_LAUNCHER_CAPTURE_DIR", str(tmp_path / "cap"))
    k = pc.WisdomKernel(pc.get_kernel("matmul"), wisdom_dir=tmp_path / "w")
    a, b = torch.randn(32, 64), torch.randn(64, 16)
    k(a, b)
    k(a, b)     # a second capture of the same scenario overwrites the first
    pattern = str(tmp_path / "cap" / "*.capture.json")
    assert len(glob.glob(pattern)) == 1
    argv = ["--captures", pattern, "--device", "cpu", "--budget-evals", "2",
            "--wisdom-dir", str(tmp_path / "w")]
    assert tune_cli.main(argv + ["--dry-run"]) == 0
    assert "would tune matmul 32x16x64 float32 on cpu" in \
        capsys.readouterr().out
    assert tune_cli.main(argv) == 0
    k.invalidate()
    monkeypatch.delenv(pc.CAPTURE_ENV)
    k(a, b)
    assert k.last_tier == "exact"


def test_costmodel_objective_is_not_ported():
    b = pc.get_kernel("matmul")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tune_kernel(b, (32, 16, 64), "float32", "cpu",
                    objective="costmodel", device="cpu")


def test_evaluator_marks_build_failures_and_wrong_outputs_infeasible(
        monkeypatch):
    b = pc.get_kernel("matmul")
    args = b.make_probe_args((32, 16, 64), "float32")
    ev = WallClockEvaluator(b, args, device="cpu", repeats=2)
    cfg = b.default_config()
    assert ev(cfg).feasible and ev(cfg).verified

    def broken_build(config, meta):
        raise KernelBuildError("nvcc failed on matmul.cu (exit 1):\nerror")

    monkeypatch.setattr(b, "make", broken_build)
    r = ev(cfg)
    assert not r.feasible and "nvcc failed" in r.error
    monkeypatch.setattr(b, "make", lambda config, meta:
                        lambda x, y: torch.zeros(32, 16))
    r = ev(cfg)
    assert not r.feasible and r.verified is False
    assert "allclose failed" in r.error
    assert not ev(cfg | {"block_k": 7}).feasible      # outside the space


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for main in (quickstart.main, tune_microhh.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main([])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tune_cli.main(["--captures", "nothing-matches-*"])


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_fault_check_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(REPO / "chip_fault_check.py")],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
