"""CPU rehearsals of each cell's loop at tiny sizes: the result line has
the contract's shape, sound runs come out correct, and runs with the timed
path broken underneath come out not correct."""

import json

import pytest
import torch

from klbench import guard, harness, run as entry
from repro_torch.models.transformer import DecoderLM
from repro_torch.train import step as train_step

ROOT = harness.KLBENCH.parent
TINY = dict(name="tiny", num_hidden_layers=2, hidden_size=256,
            num_attention_heads=4, num_key_value_heads=2, head_dim=128,
            intermediate_size=512, vocab_size=512, rope_theta=1e6,
            rms_norm_eps=1e-6,
            qkv_bias=True, tie_word_embeddings=False,
            torch_dtype="bfloat16")
SEED = 2**31 + 11


def tiny_run(cell: str, trace: bool = False) -> harness.Run:
    """The cell as committed, cut to a size the CPU runs in seconds."""
    run = harness.make_run(ROOT, cell, SEED, 0.3, trace, "cpu", 0.0)
    t = run.traffic
    if t["loop"] == "stencil_steps":
        t.update(grid=[8, 12, 16], keep_window=4)
    elif t["loop"] == "prefill":
        run.config = TINY
        t.update(shapes=[[2, 128], [1, 256]], weights=[1, 1], pool=8)
    else:
        run.config = TINY
        t.update(batch=4, seq=128, pool=8)
    return run


def result_line(run, capsys, trace=False) -> dict:
    readers = harness.metric_readers(harness.benchmark(ROOT), run.cell) \
        if trace else {}
    entry.emit(harness.execute(run, readers))
    out, err = capsys.readouterr()
    last = out.strip().splitlines()[-1]
    doc = json.loads(last)
    assert list(doc)[-1] == "checks"
    assert err.strip().splitlines()[-len(doc["checks"]):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in doc["checks"].items()]
    return doc


CELLS = [w["name"] for w in harness.benchmark(ROOT)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_prints_the_contracts_line(cell, capsys):
    run = tiny_run(cell)
    doc = result_line(run, capsys)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(doc)
    assert doc["correct"] is True and doc["failed"] == 0
    assert doc["attempted"] >= 1
    names = {m["name"] for m in harness.benchmark(ROOT)["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(doc["metrics"]) == names
    assert all(set(m) == {"value", "unit"} for m in doc["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        doc["device"])


def test_a_traced_run_gives_the_window_and_a_breakdown(capsys):
    doc = result_line(tiny_run("microhh-f32.grid256", trace=True), capsys,
                      trace=True)
    assert doc["correct"] is True
    assert doc["device"]["window_s"] > 0 and "busy_s" in doc["device"]
    assert set(doc["breakdown"]) == {"device_ops", "idle_gaps"}


def altered(fn, fix):
    def wrapper(*args, **kwargs):
        return fix(fn(*args, **kwargs))
    return wrapper


def test_an_altered_stencil_answer_is_not_correct(monkeypatch, capsys):
    from repro_torch.kernels import ops

    def bump(ut):
        ut = ut.clone()
        ut[1, 2, 3] += 1.0
        return ut

    monkeypatch.setattr(ops, "advec_u", altered(ops.advec_u, bump))
    assert result_line(tiny_run("microhh-f32.grid512"), capsys)[
        "correct"] is False


def test_an_altered_prefill_answer_is_not_correct(monkeypatch, capsys):
    def swap(out):
        logits, cache = out
        return logits.roll(1, dims=-1), cache

    monkeypatch.setattr(DecoderLM, "prefill",
                        altered(DecoderLM.prefill, swap))
    assert result_line(tiny_run("codeqwen1.5-7b.prefill-mix"), capsys)[
        "correct"] is False


def test_an_altered_cache_entry_is_not_correct(monkeypatch, capsys):
    def zero_k(out):
        logits, cache = out
        cache["kv"]["k"][0, :, :, -1] = 0
        return logits, cache

    monkeypatch.setattr(DecoderLM, "prefill",
                        altered(DecoderLM.prefill, zero_k))
    doc = result_line(tiny_run("codeqwen1.5-7b.prefill-mix"), capsys)
    assert doc["correct"] is False
    assert doc["checks"]["kv_rel_l2"]["value"] > doc["checks"][
        "kv_rel_l2"]["limit"]


def broken_train_step(monkeypatch, fault):
    make = train_step.make_train_step

    def make_broken(model, opt, **kw):
        step = make(model, opt, **kw)

        def broken(state, batch):
            if fault == "unchanged":
                return state, step(state, batch)[1]
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(state, half)
        return broken

    monkeypatch.setattr(train_step, "make_train_step", make_broken)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(fault, monkeypatch, capsys):
    broken_train_step(monkeypatch, fault)
    doc = result_line(tiny_run("codeqwen1.5-7b.train"), capsys)
    assert doc["correct"] is False


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    assert guard.loaded({"repro_torch.kernels": 1, "reprox": 1}) == []
    assert guard.loaded({"repro.core.wisdom": 1, "jaxlib": 1}) == [
        "jaxlib", "repro"]
    monkeypatch.setitem(__import__("sys").modules, "flax", object())
    with pytest.raises(SystemExit) as e:
        guard.check()
    assert e.value.code == 3


def test_without_a_card_the_run_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = entry.main(["--workload", "microhh-f32.grid512", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    out, _ = capsys.readouterr()
    assert rc == 2 and out == ""
