"""The port's core (device model, captures, wisdom, WisdomKernel) against
the JAX package's: the same files in, the same selections out."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import device as repro_device
from repro.tuner import tune_kernel as repro_tune_kernel

import repro_torch.core as pc
from repro_torch.core import device as port_device

REPO = Path(__file__).resolve().parent.parent

# The tensors here are small: one intra-op thread keeps these tests off
# the cores that parallel test workers need.
torch.set_num_threads(1)

# ------------------------------------------------------------ device model

PARSE_CASES = [
    ("NVIDIA H100 80GB HBM3", "gpu", "gpu-h100"),
    ("NVIDIA H100 PCIe", "gpu", "gpu-h100"),
    ("NVIDIA H100 NVL", "", "gpu-h100"),
    ("NVIDIA A100-SXM4-40GB", "gpu", "gpu-a100"),
    ("NVIDIA RTX A4000", "", "gpu-a4000"),
    ("TPU v5 lite", "tpu", "tpu-v5e"),
    ("TPU v4", "", "tpu-v4"),
    ("cpu", "cpu", "cpu"),
]


@pytest.mark.parametrize("raw,platform,kind", PARSE_CASES)
def test_parse_device_kind(raw, platform, kind):
    assert port_device.parse_device_kind(raw, platform) == kind
    if "H100" not in raw:   # the reference agrees wherever it knows the part
        assert repro_device.parse_device_kind(raw, platform) == kind


def test_h100_is_a_real_spec_where_the_reference_estimates():
    spec = port_device.get_device("gpu-h100")
    assert not spec.estimated
    assert (spec.family, spec.backend) == ("gpu-hopper", "gpu")
    assert spec.hbm_bw == 3.35e12 and spec.flops_f32 == 67e12
    assert spec.flops_bf16 == 989e12
    assert spec.smem_per_block == 232_448 and spec.regs_per_sm == 65_536
    assert repro_device.get_device(
        repro_device.parse_device_kind("NVIDIA H100 80GB HBM3")).estimated


def test_other_specs_match_the_reference():
    for kind, spec in repro_device.DEVICES.items():
        mine = port_device.get_device(kind)
        assert (mine.family, mine.flops_bf16, mine.hbm_bw, mine.backend) == (
            spec.family, spec.flops_bf16, spec.hbm_bw, spec.backend)


def test_device_env_override_and_cpu_kind(monkeypatch):
    monkeypatch.setenv(pc.DEVICE_ENV, "gpu-h100")
    assert pc.current_device_kind() == "gpu-h100"
    monkeypatch.delenv(pc.DEVICE_ENV)
    assert pc.current_device_kind("cpu") == "cpu"


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        pc.resolve_device("cuda")
    assert pc.resolve_device("cpu").type == "cpu"


# ------------------------------------------------------------ wisdom parity

SCENARIOS = [
    ("matmul", (256, 256, 256), "float32", "tpu-v5e"),
    ("matmul", (512, 512, 1024), "float32", "tpu-v5e"),
    ("matmul", (256, 256, 256), "bfloat16", "tpu-v4"),
    ("advec_u", (64, 64, 128), "float32", "tpu-v5e"),
    ("advec_u", (128, 128, 128), "bfloat16", "tpu-v5e"),
]

QUERIES = [
    # kernel, device kind, problem, dtype, expected tier
    ("matmul", "tpu-v5e", (256, 256, 256), "float32", "exact"),
    ("matmul", "tpu-v5e", (384, 384, 512), "float32", "device+dtype"),
    ("matmul", "tpu-v5e", (256, 256, 256), "bfloat16", "device"),
    ("matmul", "tpu-v5-lite-x", (256, 256, 256), "float32", "family+dtype"),
    ("matmul", "tpu-v4", (256, 256, 256), "float32", "device"),
    ("matmul", "gpu-h100", (1024, 1024, 1024), "float32", "any+dtype"),
    ("matmul", "cpu", (64, 64, 64), "float16", "any"),
    ("advec_u", "tpu-v5e", (64, 64, 128), "float32", "exact"),
    ("advec_u", "tpu-v5e", (256, 256, 256), "bfloat16", "device+dtype"),
    ("advec_u", "gpu-h100", (512, 512, 512), "float32", "any+dtype"),
    ("diff_uvw", "gpu-h100", (256, 256, 256), "float32", "default"),
]


@pytest.fixture(scope="module")
def repro_wisdom_dir(tmp_path_factory):
    """Wisdom written by the JAX package's own tuner (cost model)."""
    d = tmp_path_factory.mktemp("repro-wisdom")
    for kernel, problem, dtype, device in SCENARIOS:
        repro_tune_kernel(rc.get_kernel(kernel), problem, dtype, device,
                          strategy="random", max_evals=6, wisdom_dir=d,
                          seed=1)
    return d


@pytest.mark.parametrize("query", QUERIES, ids=lambda q: f"{q[0]}-{q[4]}")
def test_select_record_parity(repro_wisdom_dir, query):
    kernel, kind, problem, dtype, tier = query
    want_rec, want_tier = rc.Wisdom.load(kernel, repro_wisdom_dir) \
        .select_record(kind, problem, dtype)
    got_rec, got_tier = pc.Wisdom.load(kernel, repro_wisdom_dir) \
        .select_record(kind, problem, dtype)
    assert got_tier == want_tier == tier
    if want_rec is None:
        assert got_rec is None
    else:
        assert got_rec.record_id() == want_rec.record_id()
        assert got_rec.config == want_rec.config


def test_port_wisdom_loads_in_repro(tmp_path):
    w = pc.Wisdom("matmul")
    spec = pc.get_device("gpu-h100")
    w.add(pc.WisdomRecord(
        device_kind=spec.kind, device_family=spec.family,
        problem_size=(512, 512, 1024), dtype="float32",
        config={"block_m": 64, "block_n": 128, "block_k": 16,
                "grid_order": "nmk"},
        score_us=41.5, provenance=pc.make_provenance("bayes", 12,
                                                     "wallclock")))
    w.save(tmp_path)
    doc = json.loads((tmp_path / "matmul.wisdom.json").read_text())
    assert doc["version"] == rc.WISDOM_VERSION == pc.WISDOM_VERSION
    back = rc.Wisdom.load("matmul", tmp_path)
    assert [r.to_json() for r in back.records] == \
        [r.to_json() for r in w.records]
    assert back.records[0].record_id() == w.records[0].record_id()
    rec, tier = back.select_record("gpu-h100", (512, 512, 1024), "float32")
    assert tier == "exact" and rec.config["grid_order"] == "nmk"


def test_provenance_names_torch_and_cuda_not_jax():
    prov = pc.make_provenance("bayes", 3, "wallclock")
    assert prov["torch_version"] == torch.__version__
    assert "cuda_version" in prov and "jax_version" not in prov


def _tpu_record(kind, problem):
    cfg = rc.get_kernel("matmul").default_config()
    return rc.WisdomRecord(device_kind=kind, device_family="tpu-v5",
                           problem_size=problem, dtype="float32",
                           config=cfg, score_us=1.0,
                           provenance={"evaluations": 1})


def test_tpu_record_is_never_launched(tmp_path, monkeypatch):
    """A TPU config exactly matching the launch's scenario is refused by
    the port's space: the port drops it and launches its own default."""
    w = rc.Wisdom("matmul")
    w.add(_tpu_record("tpu-v5e", (64, 32, 48)))
    w.save(tmp_path)
    b = pc.get_kernel("matmul")
    made = []
    real_make = b.make
    monkeypatch.setattr(b, "make", lambda cfg, meta: made.append(cfg)
                        or real_make(cfg, meta))
    k = pc.WisdomKernel(b, wisdom_dir=tmp_path, device_kind="tpu-v5e")
    a, bb = torch.randn(64, 48), torch.randn(48, 32)
    out = k(a, bb)
    assert k.last_tier == "default" and k.foreign_records == 1
    assert made == [b.default_config()]
    torch.testing.assert_close(out, a @ bb, rtol=1e-5, atol=1e-5)


def test_tpu_record_does_not_shadow_a_launchable_one(tmp_path):
    w = rc.Wisdom("matmul")
    w.add(_tpu_record("tpu-v5e", (64, 32, 48)))
    cfg = pc.get_kernel("matmul").default_config() | {"block_k": 32}
    w.add(rc.WisdomRecord(device_kind="tpu-v5e", device_family="tpu-v5",
                          problem_size=(128, 128, 128), dtype="float32",
                          config=cfg, score_us=2.0))
    w.save(tmp_path)
    k = pc.WisdomKernel(pc.get_kernel("matmul"), wisdom_dir=tmp_path,
                        device_kind="tpu-v5e")
    assert k.select_config((64, 32, 48), "float32") == (cfg, "device+dtype")


# ------------------------------------------------------------ launches

def test_wisdom_kernel_stats_on_cpu(tmp_path):
    k = pc.WisdomKernel(pc.get_kernel("matmul"), wisdom_dir=tmp_path)
    a, b = torch.randn(32, 16), torch.randn(16, 8)
    k(a, b)
    k(a, b)
    first, second = k.stats
    assert (first.cached, second.cached) == (False, True)
    assert first.tier == "default" and first.load_s == 0.0
    assert first.launch_s > 0 and second.compile_s == 0.0
    assert k.tier_counts == {"default": 2}


# ------------------------------------------------------------ captures

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_torch_round_trip_keeps_bits(dtype):
    x = np.asarray(jnp.asarray(np.linspace(-3, 3, 24, dtype=np.float32)
                               .reshape(4, 6), dtype))
    t = pc.to_torch(x, dtype)
    assert pc.dtype_name(t.dtype) == dtype
    back, name = pc.to_numpy(t)
    assert name == dtype
    assert back.tobytes() == x.tobytes()
    np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                  np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_capture_loads_in_repro(tmp_path, dtype):
    t = torch.randn(4, 6).to(pc.torch_dtype(dtype))
    scal = torch.tensor([[1.1, 0.9, 1.3, 0.0]])
    path = pc.write_capture("advec_u", (4, 6), dtype, [t, scal], tmp_path)
    cap = rc.load_capture(path)
    assert cap.dtype == dtype and cap.meta["arg_dtypes"] == [dtype, "float32"]
    assert cap.args[0].tobytes() == pc.to_numpy(t)[0].tobytes()
    back = pc.load_capture(path)
    assert torch.equal(back.args[0], t) and torch.equal(back.args[1], scal)


# ------------------------------------------------------------ no JAX inside

def test_port_imports_neither_jax_nor_repro():
    """Every module of the port, and chip_smoke.py's imports, load without
    pulling in jax or the JAX package."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(REPO / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
