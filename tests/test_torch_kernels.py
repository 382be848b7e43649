"""The port's kernels against the JAX package's.

These tests give the port's kernels CPU tensors, so they run their plain
PyTorch versions; each is held to ``repro.kernels.ref`` at
``tests/test_kernels.py``'s shapes, and once per kernel to the Pallas kernel
in interpret mode. The same
inputs, made with numpy from a seed, go to both packages. Tolerances are the
tuner's (``repro.tuner.runner._tolerances``): 1e-5 in float32 with the
absolute part scaled by max|ref|, 2e-2 in bfloat16, compared in float32 after
identical bf16 inputs. The CUDA kernels themselves are checked on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import args_meta as repro_args_meta
from repro.core import get_kernel as repro_kernel
from repro.kernels import ref as repro_ref

from repro_torch.core import args_meta, get_kernel, to_torch
from repro_torch.kernels import _build, advec_u, diff_uvw, matmul, ref

REPO = Path(__file__).resolve().parent.parent

# The tensors here are small: one intra-op thread keeps these tests off
# the cores that parallel test workers need.
torch.set_num_threads(1)
SCAL = np.array([[1.1, 0.9, 1.3, 0.0]], np.float32)
STENCIL_SHAPES = [(8, 8, 128), (16, 32, 128), (32, 16, 256), (32, 32, 128)]
MATMUL_SHAPES = [(128, 128, 256), (256, 512, 128), (64, 128, 1024)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _arrays(rng, shapes, dtype, square=()):
    """numpy inputs in ``dtype`` (bf16 as ml_dtypes), drawn in f32."""
    out = []
    for i, shape in enumerate(shapes):
        x = rng.standard_normal(shape).astype(np.float32)
        if i in square:
            x = x ** 2
        out.append(np.asarray(jnp.asarray(x, dtype)))
    return out


def _port(arrays, dtype):
    return [to_torch(a, dtype) for a in arrays]


def _assert_close(got, want, dtype):
    """got: torch tensor(s); want: array(s). Compared in float32/64."""
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    tol = TOL[dtype]
    for g, w in zip(got, want):
        g = g.to(torch.float64).numpy()
        w = np.asarray(w, np.float64)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", STENCIL_SHAPES)
def test_advec_u_plain_matches_repro(rng, shape, dtype):
    u, v, w = _arrays(rng, [shape] * 3, dtype)
    want = repro_ref.advec_u_ref(u, v, w, SCAL)
    got = advec_u.launch(advec_u.builder.default_config(),
                         *_port([u, v, w], dtype), torch.from_numpy(SCAL))
    assert got.dtype == to_torch(np.asarray(want), dtype).dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", STENCIL_SHAPES)
def test_diff_uvw_plain_matches_repro(rng, shape, dtype, fuse):
    u, v, w, e = _arrays(rng, [shape] * 4, dtype, square=(3,))
    want = repro_ref.diff_uvw_ref(u, v, w, e, SCAL)
    b = get_kernel("diff_uvw")
    args = [*_port([u, v, w, e], dtype), torch.from_numpy(SCAL)]
    fn = b.make(b.default_config() | {"fuse_outputs": fuse}, args_meta(*args))
    _assert_close(fn(*args), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_diff_uvw_fused_and_single_agree(rng, dtype):
    u, v, w, e = _port(_arrays(rng, [(16, 32, 128)] * 4, dtype, square=(3,)),
                       dtype)
    scal = torch.from_numpy(SCAL)
    cfg = diff_uvw.builder.default_config()
    fused = diff_uvw.launch_fused(cfg, u, v, w, e, scal)
    single = [diff_uvw.launch_single(cfg, f, e, scal) for f in (u, v, w)]
    for a, b in zip(fused, single):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mnk", MATMUL_SHAPES)
def test_matmul_plain_matches_repro(rng, mnk, dtype):
    m, n, k = mnk
    a, b = _arrays(rng, [(m, k), (k, n)], dtype)
    want = repro_ref.matmul_ref(a, b)
    got = matmul.launch(matmul.builder.default_config(), *_port([a, b], dtype))
    assert got.shape == (m, n)
    _assert_close(got, want, dtype)


INTERPRET_CASES = {
    # name: (argument shapes, indices squared, repro config update)
    "advec_u": ([(8, 8, 128)] * 3, (), {"block_z": 4, "block_y": 8}),
    "diff_uvw": ([(8, 8, 128)] * 4, (3,), {"block_z": 4, "block_y": 8}),
    "matmul": ([(128, 256), (256, 128)], (), {}),
}


@pytest.mark.parametrize("name", sorted(INTERPRET_CASES))
def test_plain_matches_pallas_interpret(rng, name):
    """One small shape per kernel against the Pallas kernel itself."""
    shapes, square, upd = INTERPRET_CASES[name]
    arrays = _arrays(rng, shapes, "float32", square=square)
    if name != "matmul":
        arrays.append(SCAL)
    rb = repro_kernel(name)
    pallas = rb.make(rb.default_config() | upd, repro_args_meta(*arrays),
                     interpret=True)(*arrays)
    port_args = [to_torch(a, "float32") for a in arrays]
    b = get_kernel(name)
    got = b.make(b.default_config(), args_meta(*port_args))(*port_args)
    _assert_close(got, pallas, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["advec_u", "diff_uvw", "matmul"])
def test_probe_args_bit_identical_to_repro(name, dtype):
    problem = (256, 128, 64) if name == "matmul" else (8, 16, 32)
    want = repro_kernel(name).make_probe_args(problem, dtype)
    got = get_kernel(name).make_probe_args(problem, dtype)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w_t = to_torch(w, "float32" if w.dtype == np.float32 else dtype)
        assert g.dtype == w_t.dtype and torch.equal(g, w_t)


def test_kernel_modules_import_without_toolchain():
    """No nvcc and no triton on PATH: every kernel module still imports,
    and importing builds nothing."""
    code = ("import importlib, pkgutil, sys, repro_torch.kernels as k\n"
            "for m in pkgutil.iter_modules(k.__path__):\n"
            "    importlib.import_module('repro_torch.kernels.' + m.name)\n"
            "assert 'triton' not in sys.modules\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._LOADED\n")
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=str(REPO / "src"),
               CUDA_HOME="/nonexistent")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("source", ["advec_u.cu", "diff_uvw.cu", "matmul.cu"])
def test_build_command_targets_sm_90a(source, tmp_path, monkeypatch):
    defines = (("BLOCK_M", 64),)
    out = _build.library_path(source, defines)
    cmd = _build.nvcc_command(source, defines, out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC", "-DBLOCK_M=64"):
        assert flag in cmd
    assert str(_build.CSRC / source) in cmd
    assert out.parent == _build.BUILD_DIR
    # the output is keyed by source, defines and flags
    assert out != _build.library_path(source, (("BLOCK_M", 128),))
    assert (_build.CSRC / source).exists()
    # ... and by the headers beside it, hopper.cuh included: a changed
    # helper rebuilds every library
    for path in _build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path(source, defines).name == out.name
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("// changed\n")
    assert _build.library_path(source, defines).name != out.name


# ------------------------------------------------ matmul: space and plan

def test_matmul_space_refuses_tpu_configs():
    """No TPU config of the reference's space (its default included, which
    ``test_torch_core.py``'s TPU wisdom records hold) is a config of the
    port's; the default with block_k 32 is."""
    space = get_kernel("matmul").space
    rb = repro_kernel("matmul")
    tpu = list(rb.space.enumerate())
    assert rb.default_config() in tpu and len(tpu) > 100
    assert not any(space.is_valid(c) for c in tpu)
    assert space.is_valid(space.default_config() | {"block_k": 32})
    assert space.default_config() == {
        "block_m": 128, "block_n": 128, "block_k": 8, "stages": 2,
        "split_k": 1, "grid_order": "mnk"}


# (dtype, (m, n, k), aligned) -> (body, VEC)
PLAN_BODIES = {
    ("float32", (512, 512, 1024), True): ("simt", True),
    ("float32", (100, 77, 50), True): ("simt", False),
    ("float32", (128, 96, 72), False): ("simt", False),
    ("bfloat16", (512, 512, 1024), True): ("wgmma", True),
    ("bfloat16", (190, 136, 200), True): ("wgmma", True),
    ("bfloat16", (100, 77, 50), True): ("simt", False),
    ("bfloat16", (64, 64, 68), True): ("simt", False),     # k % 8 != 0
    ("bfloat16", (64, 68, 64), True): ("simt", False),     # n % 8 != 0
    ("bfloat16", (128, 96, 72), False): ("simt", False),   # not 16-aligned
}


@pytest.mark.parametrize("case", sorted(PLAN_BODIES), ids=str)
def test_matmul_plan_body_grid_workspace_smem(case):
    dtype, (m, n, k), aligned = case
    body, vec = PLAN_BODIES[case]
    for cfg in get_kernel("matmul").space.enumerate():
        p = matmul.plan(cfg, m, n, k, dtype, aligned)
        assert (p.body, p.vec) == (body, vec)
        bm, bn, sk = cfg["block_m"], cfg["block_n"], cfg["split_k"]
        tiles = (-(-m // bm), -(-n // bn))
        assert p.grid == ((*tiles, sk) if cfg["grid_order"] == "mnk"
                          else (*tiles[::-1], sk))
        assert p.workspace_bytes == (4 * sk * m * n if sk > 1 else 0)
        assert p.tile_k == (64 if body == "wgmma" else cfg["block_k"])
        if body == "wgmma":   # alignment slack, (A + B) bf16 tiles, barriers
            want = 1024 + cfg["stages"] * (bm + bn) * 64 * 2 \
                + 16 * cfg["stages"]
        else:                 # A^T (rows padded by 4) and B in f32
            want = cfg["stages"] * cfg["block_k"] * (bm + 4 + bn) * 4
        assert p.smem_bytes == want <= 232_448 and p.refusal == ""
        d = dict(matmul.defines(cfg, p))
        assert (d["BF16"], d["VEC"], d["BLOCK_K"], d["SPLIT_K"]) == (
            int(dtype == "bfloat16"), int(vec), p.tile_k, sk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plan_refuses_what_the_card_cannot_launch(dtype):
    cfg = matmul.builder.default_config() | {"block_k": 32}
    assert matmul.plan(cfg, 256, 256, 256, dtype).refusal == ""
    for upd in ({"stages": 8}, {"stages": 16, "block_m": 64}):
        bad = cfg | upd
        p = matmul.plan(bad, 256, 256, 256, dtype)
        assert p.smem_bytes > 232_448 and "shared memory" in p.refusal
        assert not matmul.fits_card(bad)
    wide = cfg | {"block_n": 512}   # 256 accumulators a thread
    assert "accumulators" in matmul.plan(wide, 256, 256, 256, dtype).refusal


@pytest.mark.parametrize("tile_k", [8, 16, 32, 64])
@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("k", sorted({k for _, _, k in MATMUL_SHAPES}
                                     | {1, 7, 1023}))
def test_matmul_split_ranges_cover_k_once(k, split, tile_k):
    ranges = matmul.split_ranges(k, tile_k, split)
    assert len(ranges) == split
    covered = np.zeros(k, np.int64)
    for begin, end in ranges:
        assert 0 <= begin <= end <= k
        if begin < end:   # an empty trailing slice sits at k
            assert begin % tile_k == 0 and (end % tile_k == 0 or end == k)
        covered[begin:end] += 1
    assert (covered == 1).all()
    # slices follow each other in z order, so the fixed-order reduction
    # adds partials of increasing k
    assert [b for b, _ in ranges] == sorted(b for b, _ in ranges)


def _cpu_args(name):
    g = torch.Generator().manual_seed(0)
    scal = torch.from_numpy(SCAL)
    if name == "matmul":
        return [torch.randn(32, 48, generator=g), torch.randn(48, 16, generator=g)]
    n = 3 if name == "advec_u" else 4
    return [torch.randn(8, 8, 16, generator=g) for _ in range(n)] + [scal]


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("name", ["advec_u", "diff_uvw", "matmul"])
def test_cpu_launch_never_invokes_the_builder(monkeypatch, name, fuse):
    def refuse(*a, **k):
        raise AssertionError("the builder ran for a CPU tensor")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    before = {k: v.launches for k, v in _build.CUDA_KERNELS.items()}
    b = get_kernel(name)
    cfg = b.default_config()
    if name == "diff_uvw":
        cfg["fuse_outputs"] = fuse
    args = _cpu_args(name)
    out = b.make(cfg, args_meta(*args))(*args)
    want = b.make_reference()(*args)
    assert all(torch.equal(o, w) for o, w in zip(
        out if isinstance(out, tuple) else [out],
        want if isinstance(want, tuple) else [want]))
    assert {k: v.launches for k, v in _build.CUDA_KERNELS.items()} == before


@pytest.mark.parametrize("name", ["advec_u", "diff_uvw", "matmul"])
def test_non_cpu_tensor_never_reaches_the_plain_version(monkeypatch, name):
    """A tensor that is not on the CPU (here on the meta device, as a
    stand-in for one on a card) gets the kernel or an error, never the
    plain version."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    for fn in ("advec_u_ref", "diff_uvw_ref", "diff_one_ref", "matmul_ref"):
        monkeypatch.setattr(ref, fn, refuse)
    args = [a.to("meta") for a in _cpu_args(name)]
    b = get_kernel(name)
    fn = b.make(b.default_config(), args_meta(*args))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args)


@pytest.mark.parametrize("case", ["shape", "dtype", "noncontiguous", "scal"])
def test_stencil_wrapper_rejects_bad_arguments(case):
    u, v, w, scal = _cpu_args("advec_u")
    if case == "shape":
        v = torch.zeros(8, 8, 8)
    elif case == "dtype":
        v = v.double()
    elif case == "noncontiguous":
        v = v.transpose(0, 2).contiguous().transpose(0, 2)
    else:
        scal = scal.double()
    with pytest.raises(ValueError):
        advec_u.launch(advec_u.builder.default_config(), u, v, w, scal)


def test_space_bounds_threads_per_block():
    for name in ("advec_u", "diff_uvw"):
        space = get_kernel(name).space
        for cfg in space.sample(np.random.default_rng(1), 200):
            threads = (cfg["block_size_x"] * cfg["block_size_y"]
                       * cfg["block_size_z"])
            assert 32 <= threads <= 1024
            assert threads * cfg["min_blocks_per_sm"] <= 2048
        assert space.is_valid(space.default_config())


# ------------------------------------------- stencils: bodies, space, plan

STENCIL_PLAN_SHAPES = [(5, 7, 9), (3, 3, 3), (24, 40, 136), (33, 17, 200),
                       (130, 20, 24), (8, 8, 128)]


def _stencil_configs(name):
    """The default, tile configs at both ends of the space and an ldg one
    of ``name``'s space ("advec_u", "diff_uvw_single" or
    "diff_uvw_fused")."""
    b = get_kernel("advec_u" if name == "advec_u" else "diff_uvw")
    base = b.default_config() | (
        {} if name == "advec_u" else {"fuse_outputs": name == "diff_uvw_fused"})
    tile = base | {"body": "tile", "block_size_z": 1, "tile_factor_z": 2}
    cfgs = [base,
            base | {"body": "ldg", "block_size_x": 128, "block_size_y": 2,
                    "block_size_z": 2, "tile_factor_z": 4, "strip_z": 64,
                    "min_blocks_per_sm": 1},
            tile | {"block_size_x": 16, "block_size_y": 2,
                    "strip_z": 32, "min_blocks_per_sm": 1},
            tile | {"block_size_x": 256, "block_size_y": 4,
                    "strip_z": 128, "min_blocks_per_sm": 1},
            tile | {"block_size_x": 32, "block_size_y": 16,
                    "strip_z": 32, "min_blocks_per_sm": 2}]
    for c in cfgs:
        assert b.space.is_valid(c), c
    return cfgs


def _plan(name, cfg, shape, dtype):
    mod = advec_u if name == "advec_u" else diff_uvw
    return mod.plan(cfg, shape, dtype)


@pytest.mark.parametrize("shape", STENCIL_PLAN_SHAPES, ids=str)
@pytest.mark.parametrize("name", ["advec_u", "diff_uvw_single",
                                  "diff_uvw_fused"])
def test_stencil_plan_covers_every_point_once(name, shape):
    """Every output point lies in exactly one block's tile and strip, on
    ragged grids and on grids smaller than a tile, in both bodies."""
    for cfg in _stencil_configs(name):
        p = _plan(name, cfg, shape, "float32")
        assert p.kernel == name and p.body == cfg["body"]
        covered = np.zeros(shape, np.int64)
        gx, gy, gz = p.grid
        for bz in range(gz):
            for by in range(gy):
                for bx in range(gx):
                    (x0, x1), (y0, y1), (z0, z1) = p.block_extent(bx, by, bz)
                    assert x0 < x1 and y0 < y1 and z0 < z1
                    covered[z0:z1, y0:y1, x0:x1] += 1
        assert (covered == 1).all()
        if p.body == "tile":
            assert p.tile == (cfg["block_size_x"], cfg["block_size_y"],
                              cfg["strip_z"]) and p.block[2] == 1
            radius = 3 if name == "advec_u" else 1
            assert p.staged_planes == min(cfg["strip_z"], shape[0]) \
                + 2 * radius
            assert p.ring == radius + 1 + 2
        else:
            assert p.smem_bytes == p.staged_planes == 0
            assert p.tile[2] == cfg["block_size_z"] * cfg["tile_factor_z"]


def _staged_indices(p, halo, bx, by, z, vec):
    """The grid cells (z, y, x arrays, each of the staged plane's (rows,
    pitch)) that tile block (bx, by) stages for one field at staged plane
    z (z0 - radius + p, not yet wrapped), as ``tile::Stage`` computes them
    in ``csrc/stencil_tile.cuh``: rows and 16-byte chunks wrapped by a true
    modulo when ``vec``, single elements otherwise."""
    from repro_torch.kernels._stencil_common import chunk, stage_dims

    nz, ny, nx = p.shape
    rows, pitch, px = stage_dims(halo, p.block[0], p.block[1], p.dtype)
    x0, y0 = bx * p.tile[0], by * p.tile[1]
    ys = np.mod(y0 - halo[0] + np.arange(rows), ny)
    if vec:
        v = chunk(p.dtype)
        cx = np.mod((x0 - px) // v + np.arange(pitch) // v, nx // v)
        xs = cx * v + np.arange(pitch) % v
    else:
        xs = np.mod(x0 - px + np.arange(pitch), nx)
    return (np.full((rows, pitch), np.mod(z, nz)),
            np.broadcast_to(ys[:, None], (rows, pitch)),
            np.broadcast_to(xs[None, :], (rows, pitch)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 7, 9), (4, 6, 16), (7, 3, 48)],
                         ids=str)
@pytest.mark.parametrize("name", ["advec_u", "diff_uvw_single",
                                  "diff_uvw_fused"])
def test_tile_halo_indices_wrap_like_np_roll(name, shape, dtype):
    """The cells a tile block stages for each field, plane and block, by
    chunks and element by element, are the cells np.roll brings to the
    staged window, the window repeated where the tile and its halo are
    wider than the grid."""
    from repro_torch.kernels._stencil_common import (TILE_STENCILS, chunk,
                                                     stage_dims)

    nz, ny, nx = shape
    field = np.arange(nz * ny * nx).reshape(shape)
    radius, halos = TILE_STENCILS[name]
    # aligned fields whose rows are whole chunks go by 16-byte copies
    # (tile::vectorizable); every grid can go element by element
    vecs = {False, nx % chunk(dtype) == 0}
    for cfg in _stencil_configs(name)[2:]:
        p = _plan(name, cfg, shape, dtype)
        for halo in halos:
            rows, pitch, px = stage_dims(halo, *p.tile[:2], dtype)
            for bx in range(p.grid[0]):
                for by in range(p.grid[1]):
                    x0, y0 = bx * p.tile[0], by * p.tile[1]
                    for z in (-radius, 0, nz - 1, nz + radius - 1):
                        rolled = np.roll(field[z % nz], (halo[0] - y0,
                                                         px - x0), (0, 1))
                        want = np.tile(rolled, (-(-rows // ny),
                                                -(-pitch // nx)))
                        want = want[:rows, :pitch]
                        for vec in vecs:
                            got = field[_staged_indices(p, halo, bx, by,
                                                        z, vec)]
                            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["advec_u", "diff_uvw", "diff_uvw_fused"])
def test_every_tile_config_fits_shared_memory(name):
    """Every valid tile config's shared memory fits a block in both dtypes,
    and ``min_blocks_per_sm`` of them (with the card's 1 KB a block) fit
    an SM; the plan refuses what does not fit, and the space leaves it
    out. "diff_uvw" takes the space's unfused configs (the single-field
    kernel), "diff_uvw_fused" its fused ones."""
    from repro_torch.kernels import _stencil_common as sc

    mod = advec_u if name == "advec_u" else diff_uvw
    space = get_kernel("advec_u" if name == "advec_u" else "diff_uvw").space
    tiles = [c for c in space.enumerate() if c["body"] == "tile"
             and c.get("fuse_outputs", False) == (name == "diff_uvw_fused")]
    assert len(tiles) > 500
    for cfg in tiles:
        assert cfg["block_size_z"] == 1 and cfg["tile_factor_z"] == 2
        assert cfg["block_size_y"] >= 2
        for dtype in ("float32", "bfloat16"):
            p = mod.plan(cfg, (256, 256, 256), dtype)
            assert p.kernel == ("diff_uvw_single" if name == "diff_uvw"
                                else name)
            assert p.body == "tile" and p.refusal == ""
            assert 0 < p.smem_bytes <= 232_448
            assert cfg["min_blocks_per_sm"] * (
                p.smem_bytes + sc.SMEM_RESERVED_PER_BLOCK) <= sc.SMEM_PER_SM
    big = tiles[0] | {"block_size_x": 256, "block_size_y": 4,
                      "min_blocks_per_sm": 2}
    p = sc.plan("advec_u", big, (64, 64, 64), "float32")
    assert p.smem_bytes == 6 * 4 * (10 * 264 + 6 * 256 + 4 * 256)
    assert "of an SM" in p.refusal
    assert not get_kernel("advec_u").space.is_valid(
        big | {"body": "tile", "strip_z": 64})


def test_stencil_defaults_valid_and_no_two_configs_launch_one_kernel():
    """The defaults are valid (advec_u's runs the tile body, diff_uvw's is
    the fused ldg config it always was), and no two valid configs of a
    space build and launch the same kernel."""
    from repro_torch.kernels._stencil_common import stencil_defines

    a = get_kernel("advec_u").space
    d = get_kernel("diff_uvw").space
    assert a.is_valid(a.default_config()) and d.is_valid(d.default_config())
    assert a.default_config()["body"] == "tile"
    assert d.default_config() == {
        "body": "ldg", "block_size_x": 32, "block_size_y": 4,
        "block_size_z": 1, "tile_factor_z": 2, "strip_z": 64,
        "unravel_permutation": "xyz", "min_blocks_per_sm": 1,
        "fuse_outputs": True}
    for space, kernel_of in (
            (a, lambda c: "advec_u"),
            (d, lambda c: "fused" if c["fuse_outputs"] else "single")):
        seen = {}
        for cfg in space.enumerate():
            key = (kernel_of(cfg), stencil_defines(cfg))
            assert key not in seen, (cfg, seen.get(key))
            seen[key] = cfg
            assert dict(stencil_defines(cfg))["TILE"] == int(
                cfg["body"] == "tile")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fuse_outputs_admits_tile_where_it_fits(rng, dtype):
    """The space holds fused tile configs, each one's plan (the fused
    kernel's: four staged fields) fits the card, and ``launch_fused`` in a
    tile config on CPU tensors equals the reference's ``diff_uvw``."""
    d = get_kernel("diff_uvw")
    fused_tile = [c for c in d.space.enumerate()
                  if c["fuse_outputs"] and c["body"] == "tile"]
    assert fused_tile
    for cfg in fused_tile:
        p = diff_uvw.plan(cfg, (64, 64, 64), dtype)
        assert p.kernel == "diff_uvw_fused" and p.body == "tile"
        assert p.refusal == "" and 0 < p.smem_bytes <= 232_448
    tile = d.default_config() | {"body": "tile", "fuse_outputs": True}
    assert d.space.is_valid(tile)
    # 64 x 4: 4 buffers x 4 fields x 6 rows x a pitch of 72 (f32) or 80
    assert diff_uvw.plan(tile | {"block_size_x": 64}, (64, 64, 64),
                         dtype).smem_bytes == {"float32": 27_648,
                                               "bfloat16": 15_360}[dtype]
    u, v, w, e = _arrays(rng, [(16, 32, 128)] * 4, dtype, square=(3,))
    want = repro_ref.diff_uvw_ref(u, v, w, e, SCAL)
    got = diff_uvw.launch_fused(tile, *_port([u, v, w, e], dtype),
                                torch.from_numpy(SCAL))
    _assert_close(got, want, dtype)


def test_wisdom_from_before_the_body_axis_is_foreign():
    """A record written before the body axis (no ``body``, no ``strip_z``)
    is not launchable: WisdomKernel counts it as foreign and drops it."""
    from repro_torch.core import WisdomKernel

    k = WisdomKernel(get_kernel("advec_u"))
    old = {key: val for key, val in k.builder.default_config().items()
           if key not in ("body", "strip_z")}
    assert not k._launchable(old)
    assert k._launchable(k.builder.default_config())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["advec_u", "diff_uvw_single"])
def test_both_bodies_run_the_plain_version_on_cpu(rng, name, dtype):
    """A CPU tensor gets the plain version in either body, on a ragged grid
    smaller than a tile, held to the reference's oracle."""
    shape = (5, 7, 9)
    u, v, w, e = _arrays(rng, [shape] * 4, dtype, square=(3,))
    scal = torch.from_numpy(SCAL)
    args = _port([u, v, w, e], dtype)
    if name == "advec_u":
        want = repro_ref.advec_u_ref(u, v, w, SCAL)
    else:
        want = repro_ref.diff_uvw_ref(u, v, w, e, SCAL)[0]
    for cfg in _stencil_configs(name):
        if name == "advec_u":
            got = advec_u.launch(cfg, *args[:3], scal)
        else:
            got = diff_uvw.launch_single(cfg, args[0], args[3], scal)
        _assert_close(got, want, dtype)
