"""The port's serving stack (``repro_torch.serve``) against the JAX
package's, on the same submission scripts and the same weights.

The batcher is pure bookkeeping, so the two must agree exactly after every
operation. The engines run the reduced codeqwen1.5-7b config in float32 on
the CPU, with weights from the reference's ``DecoderLM.init`` converted by
``params_from_jax``: their run statistics must be equal, their greedy
outputs equal, and every decode step's logits within rtol = atol = 1e-4
(as the whole-model logits in ``tests/test_torch_models.py``).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as repro_arch
from repro.models import build_model as repro_build
from repro.serve import ContinuousBatcher as RefBatcher
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine

from repro_torch.configs import get_arch
from repro_torch.examples import serve_lm
from repro_torch.models import DecoderLM, build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ContinuousBatcher, Request, ServeEngine

torch.set_num_threads(1)
LOGIT_TOL = 1e-4
STATS = ("steps", "occupancy", "cohorts", "inflight_admissions",
         "requests_completed", "scenario_switches", "mode")


# ----------------------------------------------------------------- batcher

def _state(b) -> tuple:
    return ([(s.request_id, s.pos, s.max_pos, s.active, s.scenario, s.start)
             for s in b.slots], list(b.finished), list(b.rejected),
            [(r.request_id, r.prompt_len, r.max_new_tokens, r.scenario,
              r.seq) for r in b.queue],
            b.active_scenario, b.scenario_switches, b.queue_depth,
            b.active_slots, b.done())


@pytest.mark.parametrize("seed", range(6))
def test_batcher_matches_repro_on_random_scripts(seed):
    """Random interleavings of submit / admit (with an arena cursor) /
    advance / step over three scenario buckets, oversize requests
    included."""
    rng = np.random.default_rng(seed)
    n_slots = int(rng.integers(1, 5))
    ref, port = RefBatcher(n_slots, 48), ContinuousBatcher(n_slots, 48)
    rid = 0
    for _ in range(200):
        op = rng.integers(0, 4)
        if op == 0:
            args = (rid, int(rng.integers(1, 30)), int(rng.integers(1, 30)),
                    ("", "a", "b")[rng.integers(0, 3)])
            assert ref.submit(*args) == port.submit(*args)
            rid += 1
        elif op == 1:
            pos = int(rng.integers(0, 48))
            assert ref.admit(arena_pos=pos) == port.admit(arena_pos=pos)
        elif op == 2:
            i = int(rng.integers(0, n_slots))
            assert ref.advance(i) == port.advance(i)
        else:
            assert ref.step() == port.step()
        assert _state(ref) == _state(port)


# ------------------------------------------------------------------ engine

def _spy(eng, logits: list) -> None:
    decode = eng._decode

    def spy(params, cache, tokens):
        out, cache = decode(params, cache, tokens)
        logits.append(np.asarray(out, np.float32) if not
                      isinstance(out, torch.Tensor) else out.numpy())
        return out, cache

    eng._decode = spy


def _requests(cls, cfg, n=7, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid, rng.integers(0, cfg.vocab, int(rng.integers(2, 9)),
                                  dtype=np.int32),
                max_new_tokens=int(rng.integers(2, 8)),
                scenario=("", "x")[rid % 2])
            for rid in range(n)]


@pytest.fixture(scope="module")
def weights():
    rcfg = repro_arch("codeqwen1.5-7b").reduced()
    rmodel = repro_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(5))
    cfg = get_arch("codeqwen1.5-7b").reduced()
    model = build_model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                         rparams))
    return rmodel, rparams, model, params


@pytest.mark.parametrize("mode", ["token", "cohort"])
def test_engine_matches_repro(weights, mode):
    rmodel, rparams, model, params = weights
    ref = RefEngine(rmodel, rparams, n_slots=3, max_seq=16, mode=mode)
    port = ServeEngine(model, params, n_slots=3, max_seq=16, mode=mode)
    for r in _requests(RefRequest, model.cfg, n=9):
        assert ref.submit(r)
    for r in _requests(Request, model.cfg, n=9):
        assert port.submit(r)
    want_logits, got_logits = [], []
    _spy(ref, want_logits)
    _spy(port, got_logits)
    want, got = ref.run(), port.run()
    for key in STATS:
        assert getattr(got, key) == getattr(want, key), key
    assert got.mode == mode and got.requests_completed == 9
    if mode == "token":
        assert got.cohorts >= 2 and got.inflight_admissions > 0
    assert dict(got.items()) == dict(want.items())
    assert len(got_logits) == len(want_logits) == got.steps
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g, w, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_engine_auto_mode_and_temperature_sampling(weights):
    _, _, model, params = weights
    runs = []
    for _ in range(2):
        eng = ServeEngine(model, params, n_slots=2, max_seq=24,
                          temperature=0.8, rng_seed=3)
        assert eng.mode == "token"
        for r in _requests(Request, model.cfg, n=3):
            eng.submit(r)
        rep = eng.run()
        assert rep.requests_completed == 3
        assert all(0 <= t < model.cfg.vocab for v in rep.values() for t in v)
        runs.append(dict(rep.items()))
    assert runs[0] == runs[1]
    with pytest.raises(ValueError):
        ServeEngine(model, params, mode="lockstep")


def test_engine_rejects_oversize_requests(weights):
    _, _, model, params = weights
    eng = ServeEngine(model, params, n_slots=2, max_seq=16)
    assert not eng.submit(Request(0, np.arange(10, dtype=np.int32),
                                  max_new_tokens=10))
    assert eng.batcher.rejected == [0]


# ---------------------------------------------------------- entry points

def test_example_runs_on_cpu(capsys):
    out = serve_lm.main(["--device", "cpu", "--requests", "3",
                         "--max-new", "3"])
    assert out["report"].requests_completed == 3
    assert out["tokens"] == 9
    assert "tok/s" in capsys.readouterr().out


def test_example_and_build_model_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_lm.main([])
    with pytest.raises(RuntimeError, match="--device cpu"):
        build_model(get_arch("gemma2-2b").reduced())


def test_decoder_lm_has_no_default_device():
    """The public class never picks the host by itself."""
    with pytest.raises(TypeError):
        DecoderLM(get_arch("gemma2-2b").reduced())
    assert DecoderLM(get_arch("gemma2-2b").reduced(), "cpu").device == \
        torch.device("cpu")
