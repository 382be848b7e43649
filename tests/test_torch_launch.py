"""The port's launcher (``repro_torch.launch``: meshes, the cell table,
sharding rules, the dry-run) against the JAX package's
(``repro.launch``).

Specs: the port's spec of every parameter, optimiser-state, cache and
batch leaf equals the reference's for all 10 full architectures on
stand-in meshes of 16x16 and 2x16x16 (the reference's own
``SimpleNamespace`` mesh, ``tests/test_sharding_dryrun.py``). The port
keeps per-layer lists where the reference stacks ``(L, ...)`` (vision's
self layers ``(G, P-1, ...)``), so a layer's spec is the reference's
without the stacked leading entries, which must be ``None`` (no rule puts
an axis on a stacked dim). Shapes come from ``jax.eval_shape`` and from
the port's ``meta`` device: nothing is allocated.

Dry-run: reduced configs run their cells on fake meshes of 2x2 and 2x2x2
ranks (``launch.mesh.make_fake_mesh``) on ``meta``, and a reduced train
step on the host's 1x1 debug mesh gives the loss it gives without a mesh,
to float32 rounding (rtol 1e-6). A fixture tears the process group down
after each test that makes one.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch as repro_arch
from repro.configs import list_archs as repro_list_archs
from repro.launch import sharding as ref_sh
from repro.launch import shapes as ref_shapes
from repro.models import build_model as repro_build

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding as sh
from repro_torch.launch import shapes
from repro_torch.launch.dryrun import lower_cell, run_cell
from repro_torch.models import build_model, common
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)
MESHES = {
    "16x16": SimpleNamespace(axis_names=("data", "model"),
                             shape={"data": 16, "model": 16}),
    "2x16x16": SimpleNamespace(axis_names=("pod", "data", "model"),
                               shape={"pod": 2, "data": 16, "model": 16}),
}
#: Subtrees the reference stacks, and how many leading dims each stacks.
STACKED = {"layers": 1, "cross": 1, "encoder": 1, "decoder": 1}


@pytest.fixture
def group():
    """Tear down the process group a test makes."""
    yield
    mesh_mod.release()


@functools.lru_cache(maxsize=None)
def ref_params(arch: str):
    return jax.eval_shape(repro_build(repro_arch(arch)).init,
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def port_params(arch: str):
    return shapes.params_shape(get_arch(arch))


def _stacked_dims(arch: str, top: str) -> int:
    if top == "layers" and repro_arch(arch).cross_attn_period:
        return 2
    return STACKED.get(top, 0)


def ref_flat(specs) -> dict:
    """{path names: spec tuple} of a tree of the reference's specs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {ref_sh._path_names(path): tuple(spec) for path, spec in flat}


def port_flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in port_flat(sub, path + (str(key),)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in port_flat(sub, path + (str(i),)).items()}
    return {path: tree}


def assert_specs_match(arch: str, ref_specs, port_specs, root=()) -> int:
    """Every port leaf's spec is its reference leaf's with the stacked
    leading entries dropped (and those entries None). Returns the leaves
    compared."""
    ref = ref_flat(ref_specs)
    n = 0
    for path, spec in port_flat(port_specs).items():
        ref_path, drop, i = [], 0, 0
        while i < len(path):
            ref_path.append(path[i])
            k = _stacked_dims(arch, path[i]) if len(path) > i + 1 and (
                i == len(root)) else 0
            i += 1 + k
            drop += k
        want = ref[tuple(ref_path)]
        assert want[:drop] == (None,) * drop, (path, want)
        assert spec == want[drop:], (arch, path, spec, want)
        n += 1
    assert n >= len(ref)
    return n


# ----------------------------------------------------------------- specs ----

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_specs_equal_the_references(arch, mesh_name):
    mesh = MESHES[mesh_name]
    rcfg, cfg = repro_arch(arch), get_arch(arch)
    rp, pp = ref_params(arch), port_params(arch)
    for serve in (False, True):
        ref = ref_sh.param_pspecs(rp, mesh, rcfg, serve=serve)
        port = sh.param_pspecs(pp, mesh, cfg, serve=serve)
        assert_specs_match(arch, {"p": ref}, {"p": port}, root=("p",))
        assert sh.validate_specs(pp, port, mesh) == []
    count = jax.ShapeDtypeStruct((), np.int32)
    ref = ref_sh.opt_pspecs({"m": rp, "v": rp, "count": count}, mesh, rcfg)
    port = sh.opt_pspecs({"m": pp, "v": pp,
                          "count": torch.zeros((), device="meta")}, mesh, cfg)
    assert_specs_match(arch, ref, port, root=("m",))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_and_batch_specs_equal_the_references(arch, mesh_name):
    mesh = MESHES[mesh_name]
    rcfg, cfg = repro_arch(arch), get_arch(arch)
    caches = [(jax.eval_shape(lambda: repro_build(rcfg).init_cache(4, 128)),
               build_model(cfg, device="meta").init_cache(4, 128))]
    for name in ("decode_32k", "long_500k"):
        if shapes.cell_skip_reason(cfg, shapes.SHAPES[name]) is None:
            caches.append((
                ref_shapes.input_specs(rcfg, ref_shapes.SHAPES[name])["cache"],
                shapes.input_specs(cfg, shapes.SHAPES[name])["cache"]))
    for ref_cache, port_cache in caches:
        port = sh.cache_pspecs(port_cache, mesh)
        assert ref_flat(ref_sh.cache_pspecs(ref_cache, mesh)) \
            == port_flat(port)
        assert sh.validate_specs(port_cache, port, mesh) == []
    ref_batch = ref_shapes.input_specs(
        rcfg, ref_shapes.SHAPES["train_4k"])["batch"]
    port_batch = shapes.input_specs(cfg, shapes.SHAPES["train_4k"])["batch"]
    assert ref_flat(ref_sh.batch_pspecs(ref_batch, mesh)) \
        == port_flat(sh.batch_pspecs(port_batch, mesh))
    assert sh.logits_pspec(mesh, 128, cfg.padded_vocab) == tuple(
        ref_sh.logits_pspec(mesh, 128, rcfg.padded_vocab))
    assert sh.logits_pspec(mesh) == tuple(ref_sh.logits_pspec(mesh))


def test_divisibility_fallback():
    """The reference's cases: odd dims drop the axis."""
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 4, "model": 2})
    for shape, assign in (((7, 16), {0: "data", 1: "model"}),
                          ((8, 15), {0: "data", 1: "model"}),
                          ((8, 16), {0: ("data", "model")})):
        assert sh._spec(mesh, shape, assign) \
            == tuple(ref_sh._spec(mesh, shape, assign))
    assert sh._spec(mesh, (7, 16), {0: "data", 1: "model"}) \
        == (None, "model")
    assert sh._spec(mesh, (8, 16), {0: ("data", "model")}) \
        == (("data", "model"), None)
    for cfg in (None, get_arch("deepseek-v2-236b")):
        for m in MESHES.values():
            assert sh.fsdp_axes(m, cfg) == ref_sh.fsdp_axes(
                m, repro_arch(cfg.name) if cfg else None)
            assert sh.serve_tp_only(m, cfg) == ref_sh.serve_tp_only(
                m, repro_arch(cfg.name) if cfg else None)


# ----------------------------------------------------------------- shapes ----

def test_cell_table_counts_match_the_reference():
    assert list_archs() == repro_list_archs()
    assert len(shapes.all_cells()) == 40
    skips = [c for c in shapes.all_cells()
             if shapes.cell_skip_reason(get_arch(c[0]),
                                        shapes.SHAPES[c[1]])]
    assert len(skips) == 7 and all(s == "long_500k" for _, s in skips)
    assert len(shapes.runnable_cells()) == 33
    assert shapes.all_cells() == ref_shapes.all_cells()
    assert shapes.runnable_cells() == ref_shapes.runnable_cells()
    assert shapes.MICROBATCHES == ref_shapes.MICROBATCHES
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v)
            for k, v in ref_shapes.SHAPES.items()}


@pytest.mark.parametrize("arch,shape", [
    ("stablelm-1.6b", "train_4k"),
    ("gemma2-2b", "decode_32k"),
    ("rwkv6-7b", "long_500k"),
    ("llama-3.2-vision-11b", "prefill_32k"),
    ("whisper-base", "prefill_32k"),
])
def test_input_specs_are_meta_with_the_references_shapes(arch, shape):
    port = port_flat(shapes.input_specs(get_arch(arch), shapes.SHAPES[shape]))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        ref_shapes.input_specs(repro_arch(arch), ref_shapes.SHAPES[shape]))
    ref_leaves = {ref_sh._path_names(p): leaf for p, leaf in flat}
    assert set(port) == set(ref_leaves)
    for path, leaf in port.items():
        want = ref_leaves[path]
        if path[-1] == "pos":
            assert isinstance(leaf, int)
            continue
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want.shape), path
        assert str(leaf.dtype).split(".")[-1] == str(want.dtype), path


# ----------------------------------------------------------------- meshes ----

def test_constrain_batch_is_the_input_outside_a_mesh():
    x = torch.randn(4, 8, 2, 16)
    assert common.ACTIVE_MESH is None
    assert common.constrain_batch(x) is x
    assert common.constrain_batch(x, head_dim=2) is x


def test_debug_mesh_needs_a_card_unless_the_cpu_is_asked(group):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_debug_mesh()
    mesh = mesh_mod.make_debug_mesh(device="cpu")
    assert mesh_mod.mesh_shape(mesh) == {"data": 1, "model": 1}
    assert mesh_mod.mesh_device(mesh) == "cpu"


def test_constrain_batch_shards_batch_and_heads_under_a_mesh(group):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = mesh_mod.make_fake_mesh((2, 2), ("data", "model"))
    assert mesh_mod.dp_axes(mesh) == ("data",)
    assert mesh_mod.dp_size(mesh) == 2 and mesh_mod.mesh_axis(mesh, "pod") == 1
    x = DTensor.from_local(torch.empty(4, 8, 4, 16, device="meta"), mesh,
                           [Replicate(), Replicate()], run_check=False)
    with mesh_mod.use_mesh(mesh):
        y = common.constrain_batch(x, head_dim=2)
        z = common.constrain_batch(x[:3], head_dim=2)   # 3 rows: kept
    assert common.ACTIVE_MESH is None
    assert y.placements == (Shard(0), Shard(2))
    assert y.to_local().shape == (2, 8, 2, 16)
    assert z.placements == x.placements


#: One rank of a 2-rank gloo group on the host: q, k, v made from one seed
#: on both ranks, split over the ranks by ``distribute_tensor`` on the
#: batch or on the heads; prints, on rank 0, each case's max abs error of
#: the per-shard attention against the plain version on the whole tensors,
#: or None where the per-shard path declines.
_TWO_RANK_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch.kernels import ops, ref, sharded
from repro_torch.models import attention

rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
rng = np.random.default_rng(0)
out = {}
cases = {"heads": (2, 4, 2, 1), "batch": (2, 4, 2, 0),
         "kv_heads_uneven": (2, 2, 1, 1), "batch_uneven": (3, 4, 2, 0)}
for name, (b, hq, hkv, dim) in cases.items():
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, 16, 8))).float()
               for h in (hq, hkv, hkv))
    d = [distribute_tensor(t, mesh, [Shard(dim)]) for t in (q, k, v)]
    whole = ref.attention_ref(q, k, v, causal=True)
    got = sharded.local_attention(ref.attention_ref, *d, causal=True)
    out[name] = (None if got is None else
                 float((got.full_tensor() - whole).abs().max()))
    if got is not None:
        out[name + "/ops"] = float((ops.attention(*d, causal=True)
                                    .full_tensor() - whole).abs().max())
        dec = attention._decode_attention(d[0][:, :, -1:], d[1], d[2],
                                          15, 0, None)
        out[name + "/decode"] = float((dec.full_tensor() - attention
            ._decode_attention(q[:, :, -1:], k, v, 15, 0, None))
            .abs().max())
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""


def test_per_shard_attention_on_two_ranks_equals_the_whole(tmp_path):
    """Two real ranks (gloo, on the host): where q, k and v split batch or
    heads evenly, attention on each rank's shards (the plain version, the
    ``ops.attention`` entry and decode attention) gives the plain version
    of the whole tensors, to float32 rounding (1e-6); where a split is
    uneven (1 kv head, or 3 rows, over 2 ranks) the per-shard path
    declines, so no rank attends q heads whose kv heads another holds."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in ("src", os.environ.get("PYTHONPATH")) if p),
        OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANK_WORKER,
                               str(r), store], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    assert got["kv_heads_uneven"] is None and got["batch_uneven"] is None
    for name in ("heads", "batch"):
        for key in (name, name + "/ops", name + "/decode"):
            assert got[key] is not None and got[key] < 1e-6, (key, got)


# ---------------------------------------------------------------- dry-run ----

#: Reduced cells: (arch, shape, mesh); the batch is cut to 32 so every
#: microbatch of the train cells keeps a row a data rank. The reduced
#: configs have 4 q and 2 kv heads (rwkv 4 heads), so on (2, 4) the model
#: axis divides neither gemma2's kv heads nor whisper's cross-attention
#: kv heads (the head split reshards first, ``common.split_heads``; the
#: GQA attention runs per shard, ``sharded.gqa_kv_head``; decode gathers
#: q's heads against a cache split on the sequence), and on (2, 2) rwkv's
#: wkv state splits batch and heads on two mesh dims (the recurrence runs
#: per shard, ``sharded.per_shard``; its shifts pad by a cat).
DRY = [("codeqwen1.5-7b", "train_4k", (2, 2)),
       ("deepseek-moe-16b", "train_4k", (2, 2)),
       ("codeqwen1.5-7b", "decode_32k", (2, 2, 2)),
       ("deepseek-moe-16b", "decode_32k", (2, 2, 2)),
       ("gemma2-2b", "train_4k", (2, 4)),
       ("whisper-base", "decode_32k", (2, 4)),
       ("rwkv6-7b", "prefill_32k", (2, 2)),
       ("rwkv6-7b", "decode_32k", (2, 2))]


@pytest.mark.parametrize("arch,shape_name,mesh_shape", DRY)
def test_reduced_cell_dry_runs_on_a_fake_mesh(group, arch, shape_name,
                                              mesh_shape):
    cfg = get_arch(arch).reduced()
    shape = dataclasses.replace(shapes.SHAPES[shape_name], seq=128,
                                global_batch=32)
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = mesh_mod.make_fake_mesh(mesh_shape, axes)
    rec = run_cell(arch, shape_name, mesh, cfg=cfg, shape=shape,
                   verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["device"] == "meta" and rec["chips"] == np.prod(mesh_shape)
    assert rec["mesh"] == dict(zip(axes, mesh_shape))
    assert rec["collective_bytes"]["total"] > 0
    mf = rec["roofline"]["model_flops"]
    assert 0.8 * mf < rec["hlo_walk"]["flops"] * rec["chips"] < 8 * mf
    assert rec["compile_s"] == 0.0 and rec["memory_analysis"][
        "temp_bytes"] is None
    params = shapes.params_shape(cfg)
    assert sh.validate_specs(params, sh.param_pspecs(params, mesh, cfg),
                             mesh) == []
    inputs = shapes.input_specs(cfg, shape)
    cache = inputs.pop("cache", {})
    assert sh.validate_specs(cache, sh.cache_pspecs(cache, mesh), mesh) == []
    assert sh.validate_specs(inputs, sh.batch_pspecs(inputs, mesh),
                             mesh) == []


def test_mla_prefill_folds_its_blockwise_attention(group):
    """A reduced deepseek-v2-236b prefill at S 1024 (so MLA's expanded
    attention runs ``blockwise_attention_ref``) dry-runs on (2, 2). The
    chunk loops are ``trip_count.scan``s: at MLA's head dims and S 8192
    (16 x 8 chunk pairs) the folding counter runs the first, second and
    last step of each loop and counts the second for the steps between,
    the same flops and bytes as the unfolded loop, causally masked pairs
    included, in a fraction of the ops."""
    from repro_torch.kernels import ref as kref
    from repro_torch.roofline.op_count import OpCounter

    cfg = get_arch("deepseek-v2-236b").reduced()
    shape = dataclasses.replace(shapes.SHAPES["prefill_32k"], seq=1024,
                                global_batch=32)
    mesh = mesh_mod.make_fake_mesh((2, 2), ("data", "model"))
    rec = run_cell("deepseek-v2-236b", "prefill_32k", mesh, cfg=cfg,
                   shape=shape, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["collective_bytes"]["total"] > 0
    mf = rec["roofline"]["model_flops"]
    assert 0.8 * mf < rec["hlo_walk"]["flops"] * rec["chips"] < 8 * mf
    m = cfg.mla
    q = torch.empty((8, cfg.n_heads, 8192, m.d_nope + m.d_rope),
                    device="meta")
    v = torch.empty((8, cfg.n_heads, 8192, m.d_v), device="meta")
    counts = {}
    for fold in (False, True):
        with OpCounter(fold_loops=fold) as c:
            out = kref.blockwise_attention_ref(q, q, v, causal=True)
        assert out.shape == v.shape
        counts[fold] = (c.result()["flops"], c.result()["bytes"], c._ops)
    assert counts[True][:2] == counts[False][:2]
    assert counts[True][2] * 4 < counts[False][2]


#: One rank of a 4-rank gloo group on the host: a reduced gemma2-2b (4 q
#: and 2 kv heads; with ``n_heads=2, n_kv_heads=1`` neither divides 4) on a
#: (1, 4) mesh, parameters and tokens distributed by the sharding rules;
#: prints, on rank 0, each variant's max abs error of the meshed logits
#: against the run without a mesh, and max|logits|.
_FOUR_RANK_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_arch
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import use_mesh
from repro_torch.models import build_model
from repro_torch.models.common import lm_head

torch.set_num_threads(1)
rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=4)
mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
out = {}
for name, over in (("4q2kv", {}), ("2q1kv", {"n_heads": 2,
                                             "n_kv_heads": 1})):
    cfg = get_arch("gemma2-2b").reduced(**over)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 32)))
    whole = lm_head(cfg, params, model.forward(params, tokens)[0])
    dp = sh.distribute_tree(params, sh.param_pspecs(params, mesh, cfg,
                                                    serve=True), mesh)
    dt = sh.distribute_tree({"t": tokens}, sh.batch_pspecs(
        {"t": tokens}, mesh), mesh)["t"]
    with use_mesh(mesh):
        got = lm_head(cfg, dp, model.forward(dp, dt)[0]).full_tensor()
    out[name] = [float((got - whole).abs().max()),
                 float(whole.abs().max())]
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""


def test_gemma2_logits_on_four_ranks_equal_the_run_without_a_mesh(
        tmp_path):
    """Four real ranks (gloo, on the host) on a (1, 4) mesh whose model
    axis divides neither gemma2's kv heads (4 q on 2 kv: the GQA
    attention runs per shard, each rank on its one kv head) nor, in the
    second variant, any of its heads (2 q on 1 kv: ``split_heads``
    replicates them): the logits equal those of the run without a mesh
    to float32 rounding (1e-5 x max(1, max|logits|))."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in ("src", os.environ.get("PYTHONPATH")) if p),
        OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _FOUR_RANK_WORKER,
                               str(r), store], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    assert set(got) == {"4q2kv", "2q1kv"}
    for name, (err, top) in got.items():
        assert err <= 1e-5 * max(1.0, top), (name, err, top)


def test_debug_mesh_train_loss_equals_the_loss_without_a_mesh(group):
    """A reduced train step on the host's 1x1 debug mesh, through the
    dry-run, gives the step's loss without a mesh."""
    cfg = get_arch("stablelm-1.6b").reduced()
    shape = dataclasses.replace(shapes.SHAPES["train_4k"], seq=64,
                                global_batch=8)
    mesh = mesh_mod.make_debug_mesh(device="cpu")
    rec = lower_cell("stablelm-1.6b", "train_4k", mesh, verbose=False,
                     cfg=cfg, shape=shape, seed=3)
    assert rec["status"] == "ok" and rec["device"] == "cpu"
    model = build_model(cfg, device="cpu", remat=True)
    opt = AdamW(lr=cosine_schedule(3e-4, 100, 10_000))   # the dry-run's
    state = init_train_state(model, opt, 3)
    batch = shapes.input_specs(cfg, shape, device="cpu", seed=3)["batch"]
    step = make_train_step(model, opt,
                           shapes.microbatches_for("stablelm-1.6b",
                                                   "train_4k"))
    _, metrics = step(state, batch)
    assert rec["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-6)

