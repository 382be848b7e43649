"""The port's CUDA kernels on the card. Every test here needs a CUDA device
(an H100: the kernels are built for sm_90a) and skips without one. Run on
the card with:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import WisdomKernel, args_meta, get_kernel
from repro_torch.kernels import _build
from repro_torch.tuner import WallClockEvaluator, verify_outcome

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "PYTHONPATH=src python -m pytest -m gpu "
                    "tests/test_torch_gpu.py")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["advec_u", "diff_uvw", "matmul"])
def test_cuda_kernel_matches_plain_version(cuda_device, name, dtype):
    """The default config and three sampled ones, on a ragged shape."""
    b = get_kernel(name)
    problem = (128, 96, 72) if name == "matmul" else (24, 40, 136)
    args = [a.to(cuda_device) for a in b.make_probe_args(problem, dtype)]
    want = b.make_reference()(*args)
    for cfg in [b.default_config(),
                *b.space.sample(np.random.default_rng(0), 3)]:
        got = b.make(cfg, args_meta(*args))(*args)
        torch.cuda.synchronize()
        out = verify_outcome(got, want, dtype)
        assert out.ok, f"{cfg}: {out.error}"


def test_wisdom_kernel_launch_stats_on_card(cuda_device, tmp_path,
                                            monkeypatch):
    # A library an earlier test loaded would cost this process no load.
    monkeypatch.setattr(_build, "_LOADED", {})
    k = WisdomKernel(get_kernel("matmul"), wisdom_dir=tmp_path)
    a = torch.randn(96, 64, device=cuda_device)
    b = torch.randn(64, 80, device=cuda_device)
    before = _build.CUDA_KERNELS["matmul"].launches
    c1 = k(a, b)
    c2 = k(a, b)
    assert _build.CUDA_KERNELS["matmul"].launches == before + 2
    first, second = k.stats
    assert not first.cached and second.cached
    assert first.load_s > 0 and second.compile_s == second.load_s == 0.0
    assert first.launch_s > 0 and second.launch_s > 0
    assert torch.equal(c1, c2)


def test_wallclock_evaluator_on_card(cuda_device):
    b = get_kernel("advec_u")
    ev = WallClockEvaluator(b, b.make_probe_args((32, 32, 128), "float32"),
                            device=cuda_device, repeats=3)
    r = ev(b.default_config())
    assert r.feasible and r.verified and 0 < r.score_us < 1e6
    assert len(r.info["times_us"]) == 3
