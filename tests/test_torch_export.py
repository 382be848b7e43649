"""Compile-time selection baseline (paper §3) in the port: the header
export against the JAX package's, and ``StaticKernel`` against runtime
selection. Counterparts of ``tests/test_export_baseline.py``, tuned by
wall clock on the CPU (the plain versions) where the reference uses its
cost model."""

from __future__ import annotations

import pytest
import torch

from repro.core import Wisdom as RefWisdom
from repro.core.export import export_header as ref_export_header

from repro_torch.core import (Wisdom, WisdomKernel, WisdomRecord, get_kernel,
                              make_provenance)
from repro_torch.core.export import StaticKernel, export_header, load_header
from repro_torch.kernels import ref
from repro_torch.tuner import tune_kernel

torch.set_num_threads(1)
SMALL, BIG = (8, 8, 32), (16, 16, 32)


def _tune(tmp_path, grid, seed=0):
    return tune_kernel(get_kernel("advec_u"), grid, "float32", "gpu-h100",
                       strategy="random", max_evals=6, time_budget_s=30,
                       wisdom_dir=tmp_path, seed=seed, device="cpu",
                       repeats=1)


def test_export_and_static_kernel(tmp_path):
    b = get_kernel("advec_u")
    _tune(tmp_path, SMALL)
    hdr = export_header("advec_u", "gpu-h100", wisdom_dir=tmp_path,
                        out_dir=tmp_path / "gen")
    doc = load_header(hdr)
    assert doc["device"] == "gpu-h100"
    assert b.space.is_valid(doc["config"])
    # the C-header rendering exists and has a macro per parameter
    h = (tmp_path / "gen" / "advec_u-gpu-h100.h").read_text()
    assert h.count("#define") >= len(b.space.names)
    assert "#define ADVEC_U_BODY" in h

    u, v, w = b.make_probe_args(SMALL, "float32")[:3]
    scal = torch.tensor([[1.0, 1.0, 1.0, 0.0]])
    k = StaticKernel(b, hdr, device="cpu")
    out1 = k(u, v, w, scal)
    out2 = k(u, v, w, scal)               # built-once cache
    assert torch.equal(out1, out2)
    assert torch.equal(out1, ref.advec_u_ref(u, v, w, scal))
    assert len(k._compiled) == 1


def test_export_requires_wisdom(tmp_path):
    with pytest.raises(FileNotFoundError):
        export_header("advec_u", "gpu-h100", wisdom_dir=tmp_path,
                      out_dir=tmp_path / "gen")


def test_static_selection_is_scenario_blind(tmp_path):
    """The baked config cannot adapt across problem sizes; runtime
    selection can (the paper's central comparison): at the big grid the
    WisdomKernel serves the big grid's own record in tier exact, the
    StaticKernel the small grid's config."""
    b = get_kernel("advec_u")
    for grid in (SMALL, BIG):
        _tune(tmp_path, grid, seed=grid[0])
    hdr = export_header("advec_u", "gpu-h100", wisdom_dir=tmp_path,
                        out_dir=tmp_path / "gen", reference_problem=SMALL)
    static_cfg = load_header(hdr)["config"]

    wk = WisdomKernel(b, wisdom_dir=tmp_path, device_kind="gpu-h100")
    cfg_small, tier_small = wk.select_config(SMALL, "float32")
    cfg_big, tier_big = wk.select_config(BIG, "float32")
    assert cfg_small == static_cfg and tier_small == tier_big == "exact"
    recs = {r.problem_size: r.config
            for r in Wisdom.load("advec_u", tmp_path).records}
    assert cfg_big == recs[BIG]

    static = StaticKernel(b, hdr, device="cpu")
    args = [*b.make_probe_args(BIG, "float32")]
    assert torch.equal(static(*args), wk(*args, config=static_cfg))
    assert static.config == static_cfg       # whatever the grid


def _shared_wisdom(tmp_path):
    """One wisdom file both packages read: two scenarios of one device."""
    default = get_kernel("matmul").default_config()
    w = Wisdom("matmul")
    for problem, cfg, score in (
            ((512, 512, 1024), default | {"split_k": 2, "stages": 3}, 66.5),
            ((8192, 8192, 8192), default | {"block_k": 16}, 31220.0)):
        w.add(WisdomRecord(device_kind="gpu-h100",
                           device_family="gpu-hopper", problem_size=problem,
                           dtype="float32", config=cfg, score_us=score,
                           provenance=make_provenance(strategy="bayes")))
    w.save(tmp_path / "wisdom")
    return tmp_path / "wisdom"


@pytest.mark.parametrize("reference_problem", [None, (512, 512, 1024),
                                               (8192, 8192, 8192)])
def test_header_bytes_match_the_reference(tmp_path, reference_problem):
    """Both packages export the same .header.json and .h from one wisdom
    file."""
    wdir = _shared_wisdom(tmp_path)
    assert len(RefWisdom.load("matmul", wdir)) == 2
    port = export_header("matmul", "gpu-h100", wisdom_dir=wdir,
                         out_dir=tmp_path / "port",
                         reference_problem=reference_problem)
    want = ref_export_header("matmul", "gpu-h100", wisdom_dir=wdir,
                             out_dir=tmp_path / "ref",
                             reference_problem=reference_problem)
    assert port.read_bytes() == want.read_bytes()
    assert (tmp_path / "port" / "matmul-gpu-h100.h").read_bytes() == (
        tmp_path / "ref" / "matmul-gpu-h100.h").read_bytes()


def test_static_kernel_runs_plain_version_on_cpu_and_the_card_by_default(
        tmp_path):
    wdir = _shared_wisdom(tmp_path)
    hdr = export_header("matmul", "gpu-h100", wisdom_dir=wdir,
                        out_dir=tmp_path / "gen")
    b = get_kernel("matmul")
    a, c = b.make_probe_args((48, 40, 24), "float32")
    k = StaticKernel(b, hdr, device="cpu")
    assert torch.equal(k(a, c), ref.matmul_ref(a, c))
    a2, c2 = b.make_probe_args((16, 8, 24), "bfloat16")
    assert torch.equal(k(a2, c2), ref.matmul_ref(a2, c2))
    assert len(k._compiled) == 2             # one build per argument shape
    if not torch.cuda.is_available():        # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StaticKernel(b, hdr)
    with pytest.raises(ValueError, match="header is for 'matmul'"):
        StaticKernel(get_kernel("advec_u"), hdr, device="cpu")
