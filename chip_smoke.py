#!/usr/bin/env python3
"""Drive the port's main path on one H100 and check every kernel on it.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:

1. environment: torch, CUDA and nvcc versions, the card's name, capability
   (must be 9.0) and power limit;
2. build every kernel of the paths from ``src/repro_torch/kernels/csrc``
   (one nvcc per source and config, all started together; this includes
   every config phase 4's MicroHH tuning will time, which its seeded
   bayes search draws before any score steers it) and hold each
   CUDA kernel against its plain PyTorch version on the card: the stencils
   on the small test shapes and a ragged (5, 7, 9) in float32 and
   bfloat16, in three ldg configs and four tile ones (K1, K2a and K2b), and
   at the MicroHH grids 256^3 and 512^3 in the default and both bodies,
   each launch counted under the body its config names; matmul in five
   configs (both bodies, split_k 1/2/4, stages 2-4) at its test shapes, a
   ragged one, a bfloat16 one that TMA cannot take, (m, n, k) = (512, 512,
   1024) and 8192^3 in float32 and bfloat16 (naming the body each case
   ran), flash attention at GQA 4/4, 4/2 and
   8/1, causal and full, S 256, 512 and a ragged 200, D 128, in four
   configs (bfloat16 runs two in the wgmma body and two in the mma body;
   each line names them), and at the LM slice's prefill shape BH 128 x
   S 2048 x D 128 in bfloat16 in three configs, both bodies; then K4 at
   D 384 and 512 (the mma body with the output's head dim split across
   warps), both dtypes, causal and full, GQA 8/2, S 256 and 200, in the
   config a default launch runs there, through ``ops.attention`` with its
   launches counted, and timed at BH 16 x S 2048 causal beside the plain
   version and SDPA (its backend printed); then K4 at MLA's q/k 192 and
   v 128 with deepseek-v2-lite's YaRN softmax scale, through
   ``ops.attention`` at the benchmark cell's BH 128 x S 2048, 64 x 4096
   and 16 x 16384 (one wgmma launch a call, counted), against its plain
   version at the same scale, and timed at the first beside the plain
   version, SDPA and the workload hook's bound (the ``kernels`` line's
   ``flash_attention_d192v128_bfloat16``); then K4's backward kernel
   (``flash_attention_bwd``, bfloat16 at D 128) against the plain float32
   gradient at GQA 8/2 S 200 causal and full and at the training shape
   BH 64 x BHkv 8 x S 2048 causal, repeated for the same bits, and timed
   there beside the plain backward and SDPA's backward, in ms and as a
   share of the bf16 peak;
3. the quickstart loop: matmul (512, 512, 1024) float32, capture ->
   wall-clock tune (bayes, 20 evaluations) -> relaunch in tier "exact",
   equal to the first launch;
4. the MicroHH loop: tune advec_u and diff_uvw at 256^3 in float32 and
   bfloat16, select each in tier "exact", then launch both at 512^3 through a
   fallback tier and check them against their plain versions; the stencils'
   launches are printed by body and by (body, dtype), and advec_u must have
   run its tile body; phases 3 and 4 together must run no nvcc;
5. the LM slice on codeqwen1.5-7b at full width: (a) in float32 with 2
   layers, prefill logits (flash kernel) against the same prompt fed token
   by token through decode_step; (b) in bfloat16 with all 32 layers, prefill
   4 x 2048 tokens (32 flash launches each, all in the wgmma body) and 32
   greedy decode steps; (c) bfloat16 prefill of 256 tokens against
   decode_step; (d) capture the prefill's attention launch, tune it (8
   evaluations), and the next prefill selects tier "exact"; (e)
   ServeEngine in token mode answers 8 requests;
6. times from CUDA events beside each kernel's bound, its plain version's
   time and, for matmul and flash attention, the library call's; K1, K2a
   and K2b at 256^3 and 512^3 in both dtypes (each in the default, the
   tuned config and both bodies at one block; K2a and K2b also at the tile
   default, K2a's time beside K2b's a call); matmul in
   bfloat16 too; flash attention at the slice shape in the default
   (wgmma), tuned and one mma config; matmul (512, 512, 1024) float32 and
   flash attention at the slice shape in every config of their spaces
   (naming each flash config's body); every bound comes from the kernel's
   workload hook and ``profile_from_workload`` on the ``gpu-h100`` spec;
7. telemetry, profiles, export. Phases 3-5 run with ``repro_torch.obs``
   enabled and one profiler sampling every launch (the ambient
   ``KERNEL_LAUNCHER_PROF`` profiler, attached to ``ops``' kernels too).
   Between phases 4 and 5, after the main path's launch counts are read,
   a WisdomKernel is forced to launch diff_uvw at 512^3 in both fused
   variants of the selected config (the path's selection runs one of its
   two CUDA kernels), so both go through the launch path; their profiles
   form the "forced" group. Each profile line names the bodies its
   group's launches ran. Phase 7 checks that ``launch.count`` of each
   kernel equals the WisdomKernel stats entries the runs appended and the
   profiles taken;
   that the saved trace passes ``validate_trace``, holds one ``launch``
   span for each profiled launch, covering every CUDA kernel, and one
   ``serve.arena`` span per generation of (e); prints one profile line per
   kernel and run (main, forced, lm) and holds every roofline fraction to
   (0, 1.05]; and exports headers from the phase 3-4 wisdom (``export_header``)
   and launches ``StaticKernel`` from them at 512^3 and (512, 512, 1024)
   against a WisdomKernel forced to the same config (bit for bit for the
   stencils, the tuner's tolerance for matmul), with both times and the
   WisdomKernel's own selection beside the header's config;
8. online tuning, on copies of phase 4's wisdom with obs enabled, after
   the paths' launch counts are read: (1) advec_u and diff_uvw at 512^3
   float32, the two scenarios phase 4 launches through a fallback tier,
   each through a WisdomKernel with ``enable_online_tuning(objective=
   "wallclock", seed=0)`` for up to 400 launches: activation at the third
   miss, screening by the cost model on gpu-h100, a finished bracket of
   live trials over the 4 best-screened configs (ONLINE_BRACKET; each
   built by nvcc on the launching thread at its first trial) scored by
   their CUDA-event launch times (a variant's
   first, cold launch unscored), then either a promotion through the
   gate on the card (the next launch selects it in tier exact with
   nothing to compile, its record has online provenance
   and the verified stamp, its output holds at 512^3) or the incumbent
   kept; each prints its outcome, the chosen and incumbent configs' times,
   trial launches, screens, ``online.overhead_us`` and the trials' nvcc
   seconds apart from their launch times; (2) K2b's tile config offered
   over its ldg default to ``PromotionPipeline.promote`` by hand: tier
   exact, nothing compiled, output holds; (3) ``OracleGate`` on the card
   passes K1's tile default and vetoes the faulty kernel's wrong config;
   (4) each sandbox fault mode in a spawned child holding a CUDA context
   gives its status, a child that loses its context to a device-side
   assertion is a crash, a child builds and times K1, and this process
   launches K1 afterwards; (5) Spearman's rank correlation between the
   cost model and phase 6's stencil times at 512^3;
9. recorded spaces and transfer: (1) matmul (512, 512, 1024) float32 over
   all 216 configs and (2) causal flash attention at the LM slice's shape
   in bfloat16 over its 15 configs, each recorded by
   ``record_space(objective="wallclock")`` on the card (every config
   checked against its plain version, its first launch unscored, the best
   of 5 after L2 flushes), with entries, feasible count, best and default
   times and Spearman's rank correlation against phase 6's sweep of the
   same configs; (3) the nvcc runs while recording, which must be 0
   (phase 1 builds every config); (4) each recording replayed on the
   host: ``tunebench.compare`` over every strategy, twice, byte-identical,
   each strategy's fraction of optimum at the default budget and the
   ``--check`` verdict, ``fit_from_dataset`` quality with and without
   profile features, ``rerank_gate`` and ``classify_dataset``; (5) the
   same scenarios recorded by the cost model on gpu-a100 and gpu-a4000,
   transferred onto the card's kind and scored by ``holdout_report``
   against the card's recording (confidence, components, transfer,
   fallback and default tiers and fractions, and the fraction the
   top-ranked prediction reaches); (6) the write paths:
   ``tune_kernel(record_dataset=)`` on the quickstart scenario,
   ``SandboxedEvaluator(record_to=)`` with CUDA children, and ``transfer
   predict`` into a ``WisdomStore`` whose ``select`` on the card's
   scenario serves tier transfer only above the confidence gate;
10. fleet wisdom distribution, each item's nvcc runs and seconds printed:
   (1) ``run_local_fleet`` under the cost model over a directory each,
   the quickstart's matmul and the slice's causal flash attention on the
   card's kind, 1 worker and then 3 with w1 crashing after 13
   evaluations: byte-identical wisdom, every lease claimed once but the
   crashed shard's (twice), each winner through the coordinator's
   ``OracleGate`` on the card (its K3 and K4 launches counted) and
   placed in phase 9's recording of its scenario; (2) a coordinator and
   3 workers under a ``ManualClock``, round robin, each evaluation timed
   on the card by ``WallClockEvaluator``: matmul (512, 512, 1024) f32 in
   4 shards over its 216 configs, the assembled config beside phase 9's
   best; (3) phase 8's demand (MicroHH 512^3 f32) on a shared directory,
   ``python -m repro_torch.fleet plan``, two concurrent ``work --poll``
   children, ``coordinate --rounds 3`` (its gate launches K1 and K2a on
   the card), ``status``; each assembled config served at tier exact
   from a store pulled from the directory, its output held at 512^3;
   (4) a serving host whose store is a copy of phase 5d's wisdom pulls
   (1)'s directory from ``ServeEngine(sync=PullSync(...))`` while it
   answers phase 5e's 8 requests (served tokens/s without sync, with it
   and without it again, obs on in all three), then a 4 x 2048 prefill selects the merged K4 record at tier
   exact and its logits hold against the prefill before the pull
   within (c)'s bf16 tolerance; which record won, and its source, is
   printed; (5) phase 8 item 2's K2b promotion with a ``PushSync``
   broadcast hook, served by a second host's pull at tier exact; (6)
   ``python -m repro_torch.wisdom`` inspect, validate and diff over the
   phase's stores;
11. training: (a) codeqwen1.5-7b at full width cut to 2 layers, bf16,
   ``build_model(remat=True)``, ``make_train_step`` with 2 microbatches
   of 2 x 2048 tokens (K4 at BH 64 x S 2048 x D 128 under
   ``FlashAttentionFn``, forward and remat recompute: 8 calls a step;
   the backward kernel once a layer and microbatch: 4 a step),
   ``TrainDriver`` for 8 steps with an online tuner ticked on the first
   4, from an empty wisdom dir: each step's loss and seconds, tokens/s
   over steps 5-8, peak memory, one more step under the profiler (device
   busy share, the host's wait in event syncs), K4's calls, tiers and
   launches, the online outcome, and the final checkpoint (disk space
   read first; size, save and restore seconds, restored bit for bit);
   (b) one layer's attention input from the trained weights through
   ``ops.attention`` (K4 + ``FlashAttentionFn``) and through
   ``ref.attention_ref``, both under autograd, in bfloat16 (wgmma) and
   float32 (mma): output and q/k/v gradients within the LM slice's bf16
   bound and 1e-3 in f32, the backward kernel launched once in bf16 and
   never in f32; (c) two children started together: this script
   with ``--train-resume-child`` (the same arch reduced to d_model 256, d_head
   128, seq 128, f32, deterministic algorithms and
   ``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts: a run killed by
   ``InjectedFault`` at step 5 and resumed from step 4 ends bit for bit
   where an uninterrupted run does) and ``python -m
   repro_torch.examples.train_lm --steps 30`` (the mean loss of its last
   5 steps below its first 5);
12. the zoo's attention families, one model at a time from an empty
   wisdom directory, each freed before the next (the memory still
   allocated is printed): (a) deepseek-moe-16b at full width and depth
   (28 layers, 16.38 B parameters, bf16): prefill 4 x 2048 (K4 +28
   launches each, all wgmma), 32 greedy decode steps, profiler windows
   of one prefill and 4 decode steps (busy share, five largest kernels),
   ``ServeEngine(mode="auto")`` picking token mode for 8 requests; at a
   capacity factor of n_routed / top_k (no token drops), prefill of 512 +
   2 decode steps against ``forward`` over the 514 tokens, in float32 at
   full width with 4 layers (router free) and in bf16 on the full model
   with forward's expert choices replayed (bf16 rounds the two paths'
   router logits apart and flips near ties; with the routers free, the
   share of (token, k) expert choices that differ is held to 15 % and
   the logit errors are printed as findings); at the config's 1.25, K4
   in the first layer at its MHA 16/16 shape against its plain version,
   and the 4 x 2048 prefill with K4 against the same prefill with K4's
   plain version, routers free, its share of differing expert choices
   held to 15 %; (b) llama-3.2-vision-11b at
   full width and depth (8 cross blocks with their gates set to 1.0, 32
   self layers) with seeded (4, 576, 4096) image embeddings: prefill 4 x
   2048 (K4 +32 each), 32 decode steps, the 512 + 2 check, and K4 in the
   first self layer at its GQA 32/8 shape against its plain version; (c)
   deepseek-v2-236b at full width cut to 3 layers (the dense MLA layer 0
   and 2 MoE+MLA layers, 9.33 B parameters): prefill 2 x 2048 (K4 +3
   launches each, at MLA's q/k 192 and v 128, all wgmma), 16 absorbed
   decode steps, ``ServeEngine``
   picking cohort mode for 4 requests, and the no-drop check; (d)
   deepseek-v2-lite at full width cut to its dense layer and one dropless
   MoE layer: prefill 4 x 2048 three times (K4 +2 launches each, at q/k
   192 and v 128 with the YaRN scale, all wgmma), the MoE layer's output
   on its own input against the experts in float32 on exactly their
   routed tokens (every pair routed, at most 1 % of rows off by more
   than 5 %);
13. the recurrent and encoder-decoder families at full width and depth,
   one model at a time, each freed before the next, with seeded random
   bf16 weights whose recurrent constants are redrawn (the reference
   initialises rwkv's ``mu``, ``mu_c``, ``bonus`` and ``decay_base`` to
   0 and ``ln_x.scale`` to 1, mamba's ``A_log`` and ``dt_bias`` to 0 and
   ``D_skip`` to 1, which would hide a wrong token shift, bonus or
   decay; :func:`redraw_recurrent`): hymba-1.5b (32 layers, global
   attention in {0, 15, 31}, SWA 1024 elsewhere) and rwkv6-7b (32
   layers): prefill 4 x 2048 (a warm-up and two timed runs; rwkv's wkv
   loop is host-bound, and its one run is timed), 32 greedy decode steps,
   profiler windows of one prefill of 4 x 512 (REC_PROFILE_SEQ) and one
   decode step (busy share against a timed prefill of that length, five
   largest kernels), peak memory, ``ServeEngine(mode="auto")`` picking
   cohort mode for 8 requests on 4 slots; whisper-base (6 + 6 layers):
   ``encode`` of frames (4, 1500, 512), prefill 4 x 256, 32 decode
   steps, the profiler windows. Checks, each raising: (a) in float32 at
   full width with 2 layers, prefill's last logits against the prompt
   fed token by token through ``decode_step`` (hymba 320 tokens, 5 mamba
   chunks of 64, windows global and 128; rwkv and whisper 64), within
   1e-3 x max(1, max|ref|); (b) in bf16 at full depth, a prefill of 512
   + 2 decode steps against ``forward`` over the 514 tokens, within the
   LM slice's bf16 limits; (c) K4 launched 0 times on the path and in
   the checks (d_head 64 is no flash head dim, as in the reference).
   One line a model gives the card's name and power limit and every
   reading;
14. the multi-device launcher and the roofline (``repro_torch.launch``,
   ``repro_torch.roofline``): (a) on the production meshes, 16x16 and
   2x16x16 on fake process groups of 256 and 512 ranks holding ``meta``
   shards (the card's memory is not touched), every architecture's
   parameter specs (train and serve) and the caches of decode_32k and
   long_500k where they run must divide; then ``lower_cell`` dry-runs,
   each cell in a process of its own on the host's cores, started before
   phase 13 so it counts while the card runs phase 13 and (b),
   codeqwen1.5-7b x {train_4k, prefill_32k, decode_32k} and
   deepseek-moe-16b x train_4k on the single pod and codeqwen1.5-7b x
   train_4k on the multi-pod mesh, each ``ok`` with collective bytes > 0
   and its counted flops over all chips within 0.8-8 x ``model_flops``
   (the reference's bound), printing per-chip flops, bytes, collective
   bytes by kind, argument GiB, the roofline terms on the H100's peaks,
   the dominant term and the seconds it took; (b) on the card's 1x1
   debug mesh, codeqwen1.5-7b at full width with seeded random bf16
   weights: prefill_32k at batch 1 (32 layers, K4 at BH 32 x S 32 768),
   decode_32k at batch 2 (one step against a 32 768-token cache) and
   train_4k cut to 2 layers at batch 8 in 8 microbatches of 1 x 4096
   (remat); each counted once (K4 through its workload hook, which must
   see half the launches its counter sees) and timed once after it, by
   host clock between syncs: flops (within the bound of (a)), bytes,
   the roofline terms, ``ideal_s`` over the step, peak memory, K4's
   launches by body (> 0 in prefill and train) and the train loss
   (finite); then each cell counted again on ``meta`` under a fake 1x1
   mesh, its microbatches by trip count, beside the card's count.

Profiler windows record the card's kernels only, except phase 11's
training step, which also records host operators to read the host's wait
in event syncs.

Launch counts are set to 0 just before each path (phases 3-4, phase 5,
phase 11a's driver run) and read just after; phase 12 reads K4's
launches around each model's path (its prefills, decode steps, profiler
windows and serving), before that model's checks, and holds them to the
number of prefills times the flash layers; phase 13 holds K4's launches
around each model's path and checks to 0; phase 14 reads K4's launches
around each debug-mesh cell. Every
kernel of the path must have launched there. The
last two lines are the ``kernels`` JSON (each kernel's launches on its path,
in all and by body and dtype; K4's include phases 12 and 14) and ``{"ok": true,
"device": ...}``.
With no card, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter, defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    latest_step, load_checkpoint)
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.configs import microhh as microhh_config  # noqa: E402
from repro_torch.core import (WisdomKernel, current_device_kind,  # noqa: E402
                              get_kernel, list_captures)
from repro_torch.core.capture import CAPTURE_DIR_ENV, CAPTURE_ENV  # noqa: E402
from repro_torch.core.device import get_device  # noqa: E402
from repro_torch.core.export import (StaticKernel, export_header,  # noqa: E402
                                     load_header)
from repro_torch.core.builder import args_meta  # noqa: E402
from repro_torch.core.registry import register, unregister  # noqa: E402
from repro_torch.core.scenario import MISS_TIERS, format_key  # noqa: E402
from repro_torch.data import SyntheticTokenDataset  # noqa: E402
from repro_torch.core.wisdom import (TRANSFER_MIN_CONFIDENCE,  # noqa: E402
                                     WISDOM_DIR_ENV, Wisdom)
from repro_torch.distrib import (DirectoryTransport,  # noqa: E402
                                 MemoryTransport, PullSync, PushSync,
                                 WisdomStore, transport_wisdom)
from repro_torch.examples import quickstart, tune_microhh  # noqa: E402
from repro_torch.fleet import (ControlBus, Coordinator,  # noqa: E402
                               FleetWorker, ManualClock, publish_demand,
                               run_local_fleet, seed_demand)
from repro_torch.fleet.cli import main as fleet_cli  # noqa: E402
from repro_torch.kernels import (_build, advec_u, diff_uvw,  # noqa: E402
                                 flash_attention, flash_attention_bwd,
                                 matmul, ops, ref)
from repro_torch.kernels._stencil_common import stencil_defines  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.dryrun import (lower_cell,  # noqa: E402
                                       run_cell_process)
from repro_torch.launch.mesh import (make_debug_mesh,  # noqa: E402
                                     make_fake_mesh, make_production_mesh,
                                     release)
from repro_torch.launch.shapes import (SHAPES, cell_skip_reason,  # noqa: E402
                                       input_specs, params_shape)
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.models import mla as mla_module  # noqa: E402
from repro_torch.models import mamba as mamba_module  # noqa: E402
from repro_torch.models import moe as moe_module  # noqa: E402
from repro_torch.models.common import apply_norm, cdt  # noqa: E402
from repro_torch.obs import load_trace, validate_trace  # noqa: E402
from repro_torch.obs import runtime as obs_runtime  # noqa: E402
from repro_torch.online import enable_online_tuning  # noqa: E402
from repro_torch.online.promotion import PromotionPipeline  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.roofline import HW  # noqa: E402
from repro_torch.prof import (DEFAULT_TRAIN_EVERY, PROF_ENV,  # noqa: E402
                              classify_dataset, process_profiler,
                              profile_from_workload, rerank_gate,
                              reset_process_profiler, surrogate_rerank)
from repro_torch.sandbox import (FAULT_PARAM, KernelTrial,  # noqa: E402
                                 OracleGate, SandboxedEvaluator,
                                 SandboxSettings,
                                 clear_verdict_cache, device_assert,
                                 make_faulty_kernel, sandboxed_call)
from repro_torch.sandbox import gate as gate_module  # noqa: E402
from repro_torch.sandbox.demo import (EXPECTED_VERDICTS,  # noqa: E402
                                      run_fault_modes)
from repro_torch.runtime import InjectedFault, TrainDriver  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import (import_dynamo_off_stack,  # noqa: E402
                               init_train_state, make_train_step,
                               move_batch)
from repro_torch.transfer import (fraction_of_optimum,  # noqa: E402
                                  holdout_report, transfer_scenario)
from repro_torch.transfer.cli import main as transfer_cli  # noqa: E402
from repro_torch.transfer.score import _measured_record  # noqa: E402
from repro_torch.tunebench import (DatasetStore, SpaceDataset,  # noqa: E402
                                   dump_report, record_space)
from repro_torch.tunebench import compare as compare_strategies  # noqa: E402
from repro_torch.tuner import (CostModel, CostModelEvaluator,  # noqa: E402
                               EvalResult, WallClockEvaluator,
                               fit_from_dataset, tune_bayes, tune_capture,
                               tune_kernel)
from repro_torch.tuner.runner import (L2_FLUSH_BYTES,  # noqa: E402
                                      _tolerances, verify_outcome)

#: The spec every bound is computed against: NVIDIA's H100 SXM data sheet
#: (dense, at the 700 W limit), in ``core/device.py``.
H100 = get_device("gpu-h100")
#: The largest roofline fraction a profile may show: above 1 the kernel
#: would beat its bound, so the workload's counts would be wrong; the 5 %
#: covers the CUDA events' resolution.
MAX_ROOFLINE_FRACTION = 1.05
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SMALL_STENCIL = [(8, 8, 128), (16, 32, 128), (32, 16, 256), (32, 32, 128)]
SMALL_MATMUL = [(128, 128, 256), (256, 512, 128), (64, 128, 1024)]
#: (m, n, k) of the quickstart's launch, the main path's matmul.
QS_MATMUL = (512, 512, 1024)
BIG_MATMUL = (8192, 8192, 8192)
#: Phase 2's matmul shapes beyond the test ones: ragged (no tile divides
#: m, n or k; TMA still takes bf16), one whose bf16 rows TMA cannot take
#: (n, k not multiples of 8: the simt body reads bf16), the quickstart's
#: and 8192^3.
MATMUL_SHAPES = [*SMALL_MATMUL, (190, 136, 200), (100, 77, 50), QS_MATMUL,
                 BIG_MATMUL]
#: Stencil configs checked in the ldg body (updates of each builder's
#: default): diff_uvw's default (the ldg body as it was before the tile
#: body, advec_u's old default too), and two more.
LDG_CONFIGS = [
    {"body": "ldg", "block_size_x": 32, "block_size_y": 4, "block_size_z": 1,
     "tile_factor_z": 2, "strip_z": 64, "unravel_permutation": "xyz",
     "min_blocks_per_sm": 1},
    {"body": "ldg", "block_size_x": 128, "block_size_y": 2, "block_size_z": 2,
     "tile_factor_z": 4, "strip_z": 64, "unravel_permutation": "zyx",
     "min_blocks_per_sm": 2},
    {"body": "ldg", "block_size_x": 16, "block_size_y": 16, "block_size_z": 1,
     "tile_factor_z": 8, "strip_z": 64, "unravel_permutation": "yzx",
     "min_blocks_per_sm": 4},
]
#: advec_u's default: a tile config, checked and timed in K2a and K2b too.
TILE_DEFAULT = get_kernel("advec_u").default_config()
#: The tile body at the ldg default's block, timed beside it in phase 6.
TILE_LDG_BLOCK = {"body": "tile", "block_size_x": 32, "block_size_y": 4,
                  "strip_z": 64, "unravel_permutation": "xyz",
                  "min_blocks_per_sm": 1}
#: Stencil configs checked in the tile body (each stencil kernel): advec_u's
#: default, the ldg block, the smallest tile with the shortest strip, and
#: the widest tile with the longest.
TILE_CONFIGS = [
    TILE_DEFAULT, TILE_LDG_BLOCK,
    {"body": "tile", "block_size_x": 16, "block_size_y": 2, "strip_z": 32,
     "unravel_permutation": "xyz", "min_blocks_per_sm": 1},
    {"body": "tile", "block_size_x": 256, "block_size_y": 4, "strip_z": 128,
     "unravel_permutation": "zyx", "min_blocks_per_sm": 1},
]
#: A ragged grid smaller than a tile: nx odd (no 16-byte copy fits a row),
#: every axis shorter than some block's, the halo wider than the grid.
RAGGED_STENCIL = (5, 7, 9)
STENCILS = ("advec_u", "diff_uvw_fused", "diff_uvw_single")
#: Updates of the default (128 x 128, block_k 8, 2 stages, split_k 1):
#: split_k 1, 2 and 4, stages 2-4, 64- and 128-wide tiles; in bfloat16 one
#: (block_m 64) or two (128) warpgroups at every stage count.
MATMUL_CONFIGS = [
    {},
    {"block_m": 64, "block_n": 64, "block_k": 16, "stages": 3, "split_k": 4},
    {"block_m": 128, "block_n": 64, "block_k": 32, "stages": 4, "split_k": 2,
     "grid_order": "nmk"},
    {"block_m": 64, "block_n": 128, "block_k": 8, "stages": 2, "split_k": 2},
    {"block_m": 128, "block_n": 128, "block_k": 16, "stages": 3,
     "split_k": 4, "grid_order": "nmk"},
]
#: Extra matmul configs timed in phase 6 (bfloat16: a deeper ring).
MATMUL_TIMED = {"stages4": {"stages": 4}}
#: Updates of the default (64, 64, 128): in bfloat16 at D = 128 the default
#: and the two-warpgroup 128 x 128 run the wgmma body, the other two mma.
FA_CONFIGS = [
    {},
    {"block_q": 128, "block_k": 32, "threads": 128},
    {"block_q": 32, "block_k": 128, "threads": 64},
    {"block_q": 128, "block_k": 128, "threads": 256},
]
#: The mma-body config checked and timed at the slice shape beside the
#: wgmma default.
FA_MMA = {"block_q": 128, "block_k": 64, "threads": 128}
#: The configs checked at the slice shape: the default and the 128 x 128
#: two-warpgroup config (wgmma), and FA_MMA.
FA_SLICE_CONFIGS = [{}, FA_CONFIGS[3], FA_MMA]
FA_GQA = [(4, 4), (4, 2), (8, 1)]
#: 200: a ragged S that no block divides (the TMA edge and the key mask).
FA_SEQ = (256, 512, 200)
FA_HEAD_DIM = 128
#: K4's head dims above 256 (the mma body splits O's head dim across
#: warps): checked at GQA 8/2 (a group of 4), S 256 and a ragged 200,
#: causal and full, in both dtypes, in the config a default launch runs
#: there (``flash_attention.fit_config``), and timed causal at
#: FA_WIDE_TIMED = (BH, BHkv, S) beside the plain version and SDPA.
FA_WIDE_DIMS = (384, 512)
FA_WIDE_SEQ = (256, 200)
FA_WIDE_TIMED = (16, 16, 2048)
#: K4 at MLA's heads (q/k 192, v 128) with the YaRN softmax scale of
#: FA_MLA_ARCH, at the (BH, S) of the deepseek-v2-lite.prefill-16k cell's
#: calls (8 x 2048, 4 x 4096 and 1 x 16384 prompts of 16 heads), and
#: timed at the first; the plain version runs FA_MLA_PLAIN_ELEMS score
#: elements (about 4 GB in float32) at a time.
FA_MLA_ARCH = "deepseek-v2-lite"
FA_MLA_SHAPES = ((128, 2048), (64, 4096), (16, 16384))
FA_MLA_PLAIN_ELEMS = 1 << 30
TPU_KERNELS = {   # CUDA kernel -> the Pallas call it replaces
    "advec_u": "src/repro/kernels/advec_u.py:91",
    "diff_uvw_fused": "src/repro/kernels/diff_uvw.py:111",
    "diff_uvw_single": "src/repro/kernels/diff_uvw.py:126",
    "matmul": "src/repro/kernels/matmul.py:137",
    "flash_attention": "src/repro/kernels/flash_attention.py:123",
    # no Pallas call: the reference differentiates its plain attention
    "flash_attention_bwd": None,
}
SOURCES = {"advec_u": "advec_u.cu", "diff_uvw_fused": "diff_uvw.cu",
           "diff_uvw_single": "diff_uvw.cu", "matmul": "matmul.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu"}
#: The CUDA kernels each main path must launch.
LOOP_KERNELS = ("advec_u", "diff_uvw_fused", "diff_uvw_single", "matmul")
LM_KERNELS = ("flash_attention",)

# The LM slice: codeqwen1.5-7b at full width and depth, random weights.
LM_ARCH = "codeqwen1.5-7b"
LM_BATCH, LM_SEQ, LM_DECODE = 4, 2048, 32
#: (a) float32 prefill (flash kernel) vs decode_step (plain attention):
#: both IEEE float32, summed in other orders over 4096-wide products.
LM_F32_TOL = 1e-3
#: (c) bfloat16 over 32 layers: 8-bit mantissas round at every product,
#: norm and residual add of every layer, and prefill and decode round at
#: other places (the flash kernel rounds P to bf16; decode attention
#: rounds p). Max abs error within this share of max(1, max|ref|), and
#: relative L2 error within it too. The sound kernel reads about 0.02 on
#: both; chip_fault_check.py plants faults in the flash kernel and shows
#: that they read above this bound.
LM_BF16_TOL = 0.05


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs

def fields(shape, n: int, dtype: str, seed: int = 0) -> list[torch.Tensor]:
    """n random fields on the card; the last is the eddy viscosity when
    n == 4 (nonnegative)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = [torch.randn(shape, generator=g, device="cuda") for _ in range(n)]
    if n == 4:
        out[3] = out[3].abs() + 0.1
    return [f.to(DTYPES[dtype]) for f in out]


def scal() -> torch.Tensor:
    return torch.tensor([[1.1, 0.9, 1.3, 0.0]], device="cuda")


def matrices(m: int, n: int, k: int, dtype: str, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(m, k, generator=g, device="cuda").to(DTYPES[dtype]),
            torch.randn(k, n, generator=g, device="cuda").to(DTYPES[dtype]))


# ------------------------------------------------- kernels and plain versions

def qkv(bh: int, bhkv: int, s: int, d: int, dtype: str, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(DTYPES[dtype])
            for shape in ((bh, s, d), (bhkv, s, d), (bhkv, s, d))]


def kernel_cfg(name: str, upd: dict) -> dict:
    """The default config of CUDA kernel ``name`` updated by ``upd``."""
    if name in ("advec_u", "matmul", "flash_attention_causal",
                "flash_attention_full"):
        return get_kernel(name).default_config() | upd
    return get_kernel("diff_uvw").default_config() | upd | {
        "fuse_outputs": name == "diff_uvw_fused"}


def calls(name: str, cfg: dict, args):
    """(kernel call, plain call) for one CUDA kernel on ``args``."""
    if name == "advec_u":
        return (lambda: advec_u.launch(cfg, *args),
                lambda: ref.advec_u_ref(*args))
    if name == "diff_uvw_fused":
        return (lambda: diff_uvw.launch_fused(cfg, *args),
                lambda: ref.diff_uvw_ref(*args))
    if name == "diff_uvw_single":
        u, v, w, e, s = args
        return (lambda: tuple(diff_uvw.launch_single(cfg, f, e, s)
                              for f in (u, v, w)),
                lambda: tuple(ref.diff_one_ref(f, e, s) for f in (u, v, w)))
    if name.startswith("flash_attention"):
        causal = name == "flash_attention_causal"
        return (lambda: flash_attention.launch(cfg, *args, causal=causal),
                lambda: ref.flash_attention_ref_factory(causal)(*args))
    return (lambda: matmul.launch(cfg, *args), lambda: ref.matmul_ref(*args))


def compare(name: str, cfg: dict, args, dtype: str, label: str,
            verbose: bool = True) -> dict:
    """Run the kernel and its plain version on ``args``; raise unless they
    agree within the tuner's tolerance for ``dtype`` and, for flash
    attention, within ``flash_attention.ROW_L2_TOL`` row by row. Returns
    the max absolute error and, for flash attention, max|ref| and the
    largest relative L2 error of a row."""
    kernel, plain = calls(name, cfg, args)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    out = verify_outcome(got, want, dtype)
    check(out.ok, f"{name} {label} {dtype} {cfg}: {out.error}")
    res = {"max_abs_err": out.max_err}
    extra = ""
    if name.startswith("flash_attention"):
        res["max_abs_ref"] = float(want.abs().max())
        res["row_l2_err"] = flash_attention.row_l2_error(got, want)
        check(res["row_l2_err"] <= flash_attention.ROW_L2_TOL[dtype],
              f"{name} {label} {dtype} {cfg}: row relative L2 error "
              f"{res['row_l2_err']:.3e} > {flash_attention.ROW_L2_TOL[dtype]}")
        extra = (f" max|ref|={res['max_abs_ref']:.3g} row_l2_err="
                 f"{res['row_l2_err']:.3e} (tol "
                 f"{flash_attention.ROW_L2_TOL[dtype]:g})")
    if verbose:
        print(f"check {name:16s} {label:14s} {dtype:8s} max_abs_err="
              f"{out.max_err:.3e} {tolerance(dtype)}{extra} ok config={cfg}",
              flush=True)
    return res


def tolerance(dtype: str) -> str:
    rtol, atol = _tolerances(dtype)
    return f"tol=(rtol {rtol:g}, atol {atol:g} x max(1, max|ref|))"


def stencil_args(name: str, shape, dtype: str):
    n = 3 if name == "advec_u" else 4
    return [*fields(shape, n, dtype), scal()]


# ------------------------------------------------------------------ timing

_FLUSH = None


def time_ms(fn, reps: int = 10) -> float:
    """Median ms of ``reps`` launches of ``fn``, each after an L2 flush,
    timed with CUDA events after one warm-up call."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def builder_of(name: str):
    """The builder that launches CUDA kernel (or builder) ``name``."""
    return get_kernel("diff_uvw" if name.startswith("diff_uvw") else name)


def cuda_kernel(builder: str, cfg: dict) -> str:
    """The CUDA kernel (a key of TPU_KERNELS) a launch of ``builder`` in
    ``cfg`` runs, as the builder's kernel module says (``kernel_of``)."""
    return sys.modules[get_kernel(builder).source].kernel_of(cfg).name


def bound(name: str, shape, dtype: str, cfg: dict) -> tuple[float, str]:
    """Least time in ms for CUDA kernel ``name`` in ``cfg`` on ``shape``,
    and whether bytes or operations set it: the builder's workload hook
    (each input read once, each output written once; the unfused diff_uvw
    a call of three launches) joined with the H100's peaks by the
    program's own ``profile_from_workload``."""
    w = builder_of(name).make_workload(cfg, tuple(shape), dtype)
    check(w.valid, f"{name} {shape} {dtype} {cfg}: invalid workload")
    p = profile_from_workload(w, H100, dtype, 1.0)
    return (max(p.compute_us, p.memory_us) / 1e3,
            "operations" if p.bottleneck == "compute" else "bytes")


def library_call(a, b):
    """torch.matmul with TF32 off: the yardstick, never used by the port."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sdpa_call(q, k, v):
    """scaled_dot_product_attention, causal: the yardstick, never used by
    the port. q, k, v are (BH, S, D) with BH == BHkv."""
    return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                          is_causal=True)[0]


LIBRARY = {"matmul": library_call, "flash_attention_causal": sdpa_call}


#: Every (CUDA kernel, shape, dtype, config, ms) phase 6 times: phase 8
#: ranks the stencils' against the cost model.
TIMED: list[tuple[str, tuple, str, dict, float]] = []
#: Phase 6's whole-space sweeps, builder -> [(config, ms)]: phase 9 ranks
#: its recordings against them.
SWEEPS: dict[str, list[tuple[dict, float]]] = {}
#: Phase 8's online demand, kernel -> ScenarioTracker, and phase 9's
#: recordings on the card, builder -> SpaceDataset: phase 10 reads both.
DEMAND: dict = {}
RECORDINGS: dict[str, SpaceDataset] = {}


def timing_row(name: str, shape, dtype: str, configs: dict, args) -> dict:
    """Times of each named config, the plain version and (matmul, flash
    attention) the library call, beside the bound; printed and returned."""
    row = {"kernel": name, "shape": list(shape), "dtype": dtype}
    for label, cfg in configs.items():
        row[f"{label}_ms"] = time_ms(calls(name, cfg, args)[0])
        TIMED.append((name, tuple(shape), dtype, dict(cfg),
                      row[f"{label}_ms"]))
    row["plain_ms"] = time_ms(calls(name, next(iter(configs.values())),
                                    args)[1], reps=3)
    lib = LIBRARY.get(name)
    row["library_ms"] = time_ms(lambda: lib(*args)) if lib else None
    row["bound_ms"], row["bound_by"] = bound(
        name, shape, dtype, next(iter(configs.values())))
    print("time " + json.dumps(row), flush=True)
    return row


# ------------------------------------------------------------------ phases

def phase_environment() -> str:
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc.stdout.strip().splitlines()[-1]}")
    print(f"device {name} capability {cap} count "
          f"{torch.cuda.device_count()}")
    check(cap == (9, 0), f"expected an sm_90 card, got capability {cap}")
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    return smi


def stencil_configs(name: str) -> list[dict]:
    """The configs phase 2 checks ``name`` in: LDG_CONFIGS and
    TILE_CONFIGS."""
    return [kernel_cfg(name, u) for u in [*LDG_CONFIGS, *TILE_CONFIGS]]


#: Phase 4's evaluations a MicroHH scenario. tune_microhh's bayes search
#: starts with the default and n_init - 1 seeded draws (12 in all) before
#: any score steers it, so every config of an 8-evaluation session is
#: known before it runs and phase 1 builds them all.
MICROHH_EVALS = 8


def microhh_tuning_configs() -> list[tuple[str, dict]]:
    """(kernel, config) of each evaluation phase 4's MicroHH tuning makes:
    tune_microhh's seeded bayes search on each 256^3 scenario, replayed
    with one score for every config (its first 12 picks ignore scores)."""
    out = []
    kind = current_device_kind(torch.device("cuda"))
    for sc in microhh_config.scenarios(grids=(microhh_config.GRIDS[0],),
                                       devices=(kind,)):
        space = get_kernel(sc.kernel).space
        res = tune_bayes(space, lambda c: EvalResult(1.0, True),
                         max_evals=MICROHH_EVALS,
                         rng=np.random.default_rng(
                             tune_microhh.stable_seed(sc.key)))
        out += [(sc.kernel, e.config) for e in res.evaluations]
    return out


def phase_build() -> None:
    specs = []
    for name in STENCILS:
        src = "advec_u.cu" if name == "advec_u" else "diff_uvw.cu"
        specs += [(src, stencil_defines(c)) for c in stencil_configs(name)]
    specs += [(f"{name}.cu", stencil_defines(c))
              for name, c in microhh_tuning_configs()]
    specs += matmul_specs()
    specs += flash_specs() + flash_wide_specs() + flash_mla_specs()
    specs += [(flash_attention_bwd.kernel.source, flash_attention_bwd.defines(
        get_kernel(name).default_config(), name.endswith("causal")))
        for name in ("flash_attention_bwd_causal", "flash_attention_bwd_full")]
    specs = list(dict.fromkeys((src, tuple(d)) for src, d in specs))
    secs = _build.build_many(specs)
    print(f"built {len(specs)} libraries with nvcc -gencode "
          f"arch=compute_90a,code=sm_90a in {secs:.1f}s (parallel)",
          flush=True)


def fa_body(cfg: dict, dtype: str) -> str:
    """The body a launch of ``cfg`` at D = 128 in ``dtype`` runs."""
    return flash_attention.choose_body(dtype, FA_HEAD_DIM, cfg)


def flash_defines(cfg: dict, causal: bool, dtype: str) -> tuple:
    """The defines of the build that runs ``cfg`` at D = 128 in ``dtype``."""
    return flash_attention.defines(cfg, causal, FA_HEAD_DIM,
                                   fa_body(cfg, dtype))


def flash_specs() -> list:
    """Every flash library phases 2-6 launch: each causal config of the
    space in bfloat16 (the LM tuning phase and the sweep pick among them)
    and the check configs, causal and full, in both dtypes."""
    out = [flash_defines(c, True, "bfloat16")
           for c in get_kernel("flash_attention_causal").space.enumerate()]
    for causal in (True, False):
        name = "flash_attention_causal" if causal else "flash_attention_full"
        out += [flash_defines(kernel_cfg(name, u), causal, dtype)
                for u in FA_CONFIGS for dtype in DTYPES]
    return [("flash_attention.cu", d) for d in out]


def wide_cfg(name: str, d: int, dtype: str) -> dict:
    """The config a default launch of ``name`` runs at head dim ``d``."""
    return flash_attention.fit_config(kernel_cfg(name, {}), d, dtype)


def flash_wide_specs() -> list:
    """The flash libraries :func:`phase_wide_flash` launches."""
    out = []
    for d in FA_WIDE_DIMS:
        for dtype in DTYPES:
            for name in ("flash_attention_causal", "flash_attention_full"):
                cfg = wide_cfg(name, d, dtype)
                out.append(flash_attention.defines(
                    cfg, name == "flash_attention_causal", d,
                    flash_attention.choose_body(dtype, d, cfg)))
    return [("flash_attention.cu", d) for d in out]


def flash_mla_specs() -> list:
    """The flash library :func:`phase_mla_flash` launches: the default
    causal config at q/k 192, v 128 in bfloat16."""
    cfg = kernel_cfg("flash_attention_causal", {})
    (d, dv), = flash_attention.SPLIT_DIMS
    return [("flash_attention.cu", flash_attention.defines(
        cfg, True, d, flash_attention.choose_body("bfloat16", d, cfg, dv),
        dv))]


def matmul_specs() -> list:
    """Every matmul library phases 2-6 launch: each config of the space
    on the quickstart's float32 problem (its tuning and the sweep), and the
    check and timed configs at every phase-2 shape in both dtypes."""
    space = get_kernel("matmul").space
    out = [matmul.defines(c, matmul.plan(c, *QS_MATMUL, "float32"))
           for c in space.enumerate()]
    for u in [*MATMUL_CONFIGS, *MATMUL_TIMED.values()]:
        cfg = kernel_cfg("matmul", u)
        out += [matmul.defines(cfg, matmul.plan(cfg, *shape, dtype))
                for dtype in DTYPES for shape in MATMUL_SHAPES]
    return [("matmul.cu", d) for d in out]


def matmul_check(cfg: dict, args, want: torch.Tensor, dtype: str):
    """One matmul launch against the plain version's output ``want``
    under the tuner's tolerance: (VerifyOutcome, the body that ran)."""
    got = matmul.launch(cfg, *args)
    torch.cuda.synchronize()
    return verify_outcome(got, want, dtype), matmul.launch_plan(cfg,
                                                                *args).body


def phase_matmul() -> float:
    """Every config of MATMUL_CONFIGS against ref.matmul_ref at every
    shape of MATMUL_SHAPES in both dtypes; one line a (shape, dtype) names
    the body that ran, which must be the shape rule's. Returns the default
    config's max error on the quickstart's float32 problem."""
    headline = 0.0
    for dtype in DTYPES:
        for m, n, k in MATMUL_SHAPES:
            label = f"m{m}n{n}k{k}"
            args = matrices(m, n, k, dtype)
            want = ref.matmul_ref(*args)
            expect = ("wgmma" if dtype == "bfloat16" and n % 8 == 0
                      and k % 8 == 0 else "simt")
            errs = []
            for u in MATMUL_CONFIGS:
                out, body = matmul_check(kernel_cfg("matmul", u), args, want,
                                         dtype)
                check(out.ok, f"matmul {label} {dtype} {u}: {out.error}")
                check(body == expect, f"matmul {label} {dtype} {u}: ran the "
                      f"{body} body, the shape rule says {expect}")
                errs.append(out.max_err)
            if (m, n, k) == QS_MATMUL and dtype == "float32":
                headline = errs[0]
            print(f"check matmul           {label:17s} {dtype:8s} body="
                  f"{expect:5s} {len(errs)} configs max_abs_err="
                  f"{max(errs):.3e} {tolerance(dtype)} ok", flush=True)
            del args, want
    torch.cuda.empty_cache()
    return headline


def check_stencil(name: str, cfgs: list[dict], shape, dtype: str,
                  label: str, verbose: bool = False) -> list[float]:
    """Hold ``name`` against its plain version in each config on one
    grid; raise unless each launch ran the body its config names. Returns
    each config's max abs error."""
    k = _build.CUDA_KERNELS[name]
    args = stencil_args(name, shape, dtype)
    errs = []
    for cfg in cfgs:
        body = cfg["body"]
        n0 = k.body_launches.get(body, 0)
        errs.append(compare(name, cfg, args, dtype, label,
                            verbose=verbose)["max_abs_err"])
        check(k.body_launches.get(body, 0) - n0 == (
            3 if name == "diff_uvw_single" else 1),
            f"{name} {label} {dtype} {cfg}: did not run the {body} body")
    return errs


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the max error at
    the headline shapes."""
    headline = {}
    for dtype in DTYPES:
        for name in STENCILS:
            for body in ("ldg", "tile"):
                cfgs = [c for c in stencil_configs(name)
                        if c["body"] == body]
                shapes = [*SMALL_STENCIL, RAGGED_STENCIL]
                err = max(max(check_stencil(name, cfgs, shape, dtype,
                                            "x".join(map(str, shape))))
                          for shape in shapes)
                print(f"check {name:16s} body={body:4s} {len(cfgs)} configs"
                      f" x {len(shapes)} shapes (test shapes, ragged "
                      f"{RAGGED_STENCIL}) {dtype:8s} max_abs_err={err:.3e} "
                      f"{tolerance(dtype)} ok", flush=True)
    for dtype in DTYPES:
        for g in (256, 512):
            for name in STENCILS:   # the default and both bodies
                cfgs = [kernel_cfg(name, u)
                        for u in ({}, LDG_CONFIGS[0], TILE_DEFAULT)]
                cfgs = list({json.dumps(c, sort_keys=True): c
                             for c in cfgs}.values())
                errs = check_stencil(name, cfgs, (g, g, g), dtype, f"{g}^3",
                                     verbose=True)
                if g == 512 and dtype == "float32":
                    headline[name] = errs[0]   # the default config's
    headline["matmul"] = phase_matmul()
    fa = _build.CUDA_KERNELS["flash_attention"]
    for dtype in DTYPES:
        for name in ("flash_attention_causal", "flash_attention_full"):
            for upd in FA_CONFIGS:
                cfg = kernel_cfg(name, upd)
                body = fa_body(cfg, dtype)
                n0 = fa.body_launches.get(body, 0)
                errs = []
                for hq, hkv in FA_GQA:
                    for s in FA_SEQ:
                        args = qkv(hq, hkv, s, FA_HEAD_DIM, dtype)
                        errs.append(compare(name, cfg, args, dtype,
                                            f"gqa{hq}/{hkv} s{s}",
                                            verbose=False))
                check(fa.body_launches.get(body, 0) - n0 == len(errs),
                      f"{name} {dtype} {cfg}: not every case ran the "
                      f"{body} body")
                print(f"check {name:22s} {dtype:8s} body={body:5s} "
                      f"{len(errs)} cases (GQA 4/4, 4/2, 8/1 x S 256, 512, "
                      f"200 x D 128) max_abs_err="
                      f"{max(e['max_abs_err'] for e in errs):.3e} "
                      f"{tolerance(dtype)} row_l2_err="
                      f"{max(e['row_l2_err'] for e in errs):.3e} (tol "
                      f"{flash_attention.ROW_L2_TOL[dtype]:g}) ok config="
                      f"{json.dumps(cfg)}", flush=True)
    args = qkv(128, 128, LM_SEQ, FA_HEAD_DIM, "bfloat16")
    for upd in FA_SLICE_CONFIGS:
        cfg = kernel_cfg("flash_attention_causal", upd)
        err = compare("flash_attention_causal", cfg, args, "bfloat16",
                      f"BH128 S2048 D128 {fa_body(cfg, 'bfloat16')}")
        if not upd:
            headline["flash_attention"] = err["max_abs_err"]
    del args
    torch.cuda.empty_cache()
    return headline


def sdpa_backend(q, k, v) -> str:
    """The backend ``scaled_dot_product_attention`` serves a causal call
    on (BH, S, D) operands with."""
    try:
        choice = torch._fused_sdp_choice(q[None], k[None], v[None],
                                         is_causal=True)
        return torch.nn.attention.SDPBackend(choice).name
    except Exception as e:  # noqa: BLE001  (a private function)
        return f"unknown ({type(e).__name__}: {e})"


def phase_wide_flash() -> dict:
    """K4 at D 384 and 512 (phase 2's last part): each (D, dtype) held
    against its plain version at FA_WIDE_SEQ, causal and full, GQA 8/2;
    then ``ops.attention``, the entry every attention layer calls, on
    (2, 8, 256, D) queries against 2 kv heads, causal and full, with the
    launch counts zeroed just before and read just after (each call must
    launch K4); then K4 timed at FA_WIDE_TIMED, causal, against its plain
    version and SDPA. Returns {(D, dtype): row}."""
    t0 = time.perf_counter()
    fa = _build.CUDA_KERNELS["flash_attention"]
    rows = {}
    with tempfile.TemporaryDirectory(prefix="kl-wide-") as wdir, \
            quickstart._env(**{WISDOM_DIR_ENV: wdir}):
        ops.reload_wisdom()
        for d in FA_WIDE_DIMS:
            for dtype in DTYPES:
                errs = []
                for name in ("flash_attention_causal",
                             "flash_attention_full"):
                    cfg = wide_cfg(name, d, dtype)
                    for s in FA_WIDE_SEQ:
                        errs.append(compare(name, cfg, qkv(8, 2, s, d, dtype),
                                            dtype, f"gqa8/2 s{s} d{d}",
                                            verbose=False))
                g = torch.Generator(device="cuda").manual_seed(1)
                q, k, v = (torch.randn((2, h, 256, d), generator=g,
                                       device="cuda").to(DTYPES[dtype])
                           for h in (8, 2, 2))
                _build.reset_launch_counts()
                for causal in (True, False):
                    got = ops.attention(q, k, v, causal=causal)
                    want = ref.attention_ref(q, k, v, causal=causal)
                    out = verify_outcome(got, want, dtype)
                    check(out.ok, f"ops.attention D {d} {dtype} causal="
                          f"{causal}: {out.error}")
                launches = fa.launches
                by = dict(fa.body_launches)
                check(launches == 2 and by == {"mma": 2},
                      f"ops.attention at D {d} {dtype}: {launches} K4 "
                      f"launches {by}, want 2 in the mma body")
                cfg = wide_cfg("flash_attention_causal", d, dtype)
                bh, bhkv, s = FA_WIDE_TIMED
                args = qkv(bh, bhkv, s, d, dtype)
                err = compare("flash_attention_causal", cfg, args, dtype,
                              f"BH{bh} S{s} D{d}", verbose=False)
                kernel, plain = calls("flash_attention_causal", cfg, args)
                row = {"head_dim": d, "dtype": dtype, "config": cfg,
                       "launches": launches,
                       "max_abs_err": err["max_abs_err"],
                       "ms": time_ms(kernel),
                       "plain_ms": time_ms(plain, reps=3),
                       "library_ms": time_ms(lambda: sdpa_call(*args)),
                       "sdpa_backend": sdpa_backend(*args)}
                row["bound_ms"], row["bound_by"] = bound(
                    "flash_attention_causal", (bh, bhkv, s, d), dtype, cfg)
                print(f"check flash_attention D {d} {dtype:8s} "
                      f"{len(errs)} cases (GQA 8/2 x S 256, 200, causal "
                      f"and full) max_abs_err="
                      f"{max(e['max_abs_err'] for e in errs):.3e} "
                      f"{tolerance(dtype)} row_l2_err="
                      f"{max(e['row_l2_err'] for e in errs):.3e} ok; "
                      f"ops.attention launched K4 {launches} times "
                      f"({json.dumps(by)})", flush=True)
                print("time wide " + json.dumps(row), flush=True)
                rows[(d, dtype)] = row
                del args, q, k, v
        ops.reload_wisdom()
    torch.cuda.empty_cache()
    print(f"phase 2 (K4 at D 384 and 512) took "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return rows


def phase_mla_flash() -> dict:
    """K4 at MLA's heads (phase 2's last part): at each FA_MLA_SHAPES
    shape, ``ops.attention`` on (B, 16, S, 192) queries and keys and
    (B, 16, S, 128) values with FA_MLA_ARCH's softmax scale, the launch
    counts zeroed just before and read just after (one launch a call, in
    the wgmma body), its output held against the plain version
    (``ref.flash_attention_ref_factory``, the same scale) a few heads at a
    time; then the kernel timed at the first shape against its plain
    version and SDPA (the same scale), beside the workload hook's bound.
    Returns the timed row."""
    t0 = time.perf_counter()
    arch = get_arch(FA_MLA_ARCH)
    h, dtype = arch.n_heads, "bfloat16"
    d, dv = arch.mla.d_nope + arch.mla.d_rope, arch.mla.d_v
    scale = mla_module.softmax_scale(arch)
    fa = _build.CUDA_KERNELS["flash_attention"]
    plain = ref.flash_attention_ref_factory(True)
    cfg = kernel_cfg("flash_attention_causal", {})
    errs = []
    with tempfile.TemporaryDirectory(prefix="kl-mla-") as wdir, \
            quickstart._env(**{WISDOM_DIR_ENV: wdir}):
        ops.reload_wisdom()
        for bh, s in FA_MLA_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(bh + s)
            q, k = (torch.randn((bh // h, h, s, d), generator=g,
                                device="cuda").to(DTYPES[dtype])
                    for _ in range(2))
            v = torch.randn((bh // h, h, s, dv), generator=g,
                            device="cuda").to(DTYPES[dtype])
            _build.reset_launch_counts()
            got = ops.attention(q, k, v, causal=True, scale=scale)
            torch.cuda.synchronize()
            launches, by = fa.launches, dict(fa.body_launches)
            check(launches == 1 and by == {"wgmma": 1},
                  f"ops.attention at q/k {d}, v {dv}, BH {bh} x S {s}: "
                  f"{launches} K4 launches {by}, want 1 in the wgmma body")
            got = got.reshape(bh, s, dv)
            qf, kf, vf = (t.reshape(bh, s, -1) for t in (q, k, v))
            step = max(1, FA_MLA_PLAIN_ELEMS // (s * s))
            err = {"bh": bh, "s": s, "max_abs_err": 0.0, "row_l2_err": 0.0}
            for i in range(0, bh, step):
                want = plain(qf[i:i + step], kf[i:i + step],
                             vf[i:i + step], scale=scale)
                out = verify_outcome(got[i:i + step], want, dtype)
                check(out.ok, f"K4 q/k {d} v {dv} BH {bh} x S {s} heads "
                      f"{i}..{i + step}: {out.error}")
                err["max_abs_err"] = max(err["max_abs_err"], out.max_err)
                err["row_l2_err"] = max(err["row_l2_err"],
                                        flash_attention.row_l2_error(
                                            got[i:i + step], want))
                del want
            check(err["row_l2_err"] <= flash_attention.ROW_L2_TOL[dtype],
                  f"K4 q/k {d} v {dv} BH {bh} x S {s}: row relative L2 "
                  f"error {err['row_l2_err']:.3e} > "
                  f"{flash_attention.ROW_L2_TOL[dtype]}")
            errs.append(err)
            print(f"check flash_attention q/k {d} v {dv} {dtype} scale "
                  f"{scale:.6f} BH {bh} x S {s} causal through "
                  f"ops.attention: 1 wgmma launch, max_abs_err="
                  f"{err['max_abs_err']:.3e} {tolerance(dtype)} row_l2_err="
                  f"{err['row_l2_err']:.3e} (tol "
                  f"{flash_attention.ROW_L2_TOL[dtype]:g}) ok", flush=True)
            if (bh, s) == FA_MLA_SHAPES[0]:
                timed_args = (qf, kf, vf, q, k, v)
            del got, qf, kf, vf, q, k, v
        qf, kf, vf, q, k, v = timed_args
        bh, s = FA_MLA_SHAPES[0]
        row = {"head_dim": d, "v_dim": dv, "dtype": dtype, "scale": scale,
               "shape": [bh, bh, s, d, dv], "config": cfg, "launches": 1,
               "max_abs_err": max(e["max_abs_err"] for e in errs),
               "row_l2_err": max(e["row_l2_err"] for e in errs),
               "ms": time_ms(lambda: flash_attention.launch(
                   cfg, qf, kf, vf, scale, causal=True)),
               "plain_ms": time_ms(lambda: plain(qf, kf, vf, scale=scale),
                                   reps=3),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, scale=scale)),
               "sdpa_backend": sdpa_backend(qf, kf, vf)}
        row["bound_ms"], row["bound_by"] = bound(
            "flash_attention_causal", (bh, bh, s, d, dv), dtype, cfg)
        print("time mla " + json.dumps(row), flush=True)
        del timed_args, qf, kf, vf, q, k, v
        ops.reload_wisdom()
    torch.cuda.empty_cache()
    print(f"phase 2 (K4 at q/k {d}, v {dv}) took "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return row


#: The backward kernel's checks: GQA 8/2 at a ragged S, causal and full,
#: and the training shape (BH 64 over BHkv 8, S 2048, causal), where it is
#: also timed; each of dq, dk, dv within relative L2 FA_BWD_REL_L2 of the
#: plain float32 gradient of the same bf16 inputs, its worst row within
#: FA_BWD_ROW_L2 (tests/test_torch_gpu.py holds the same bounds).
FA_BWD_CHECKS = [((8, 2, 200, 128), True), ((8, 2, 200, 128), False),
                 ((64, 8, 2048, 128), True)]
FA_BWD_REL_L2, FA_BWD_ROW_L2 = 1e-2, 5e-2


def fa_bwd_sdpa(q, k, v, do):
    """SDPA's backward on (BH, S, D) operands, causal, GQA by
    ``enable_gqa``: the yardstick, never used by the port."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*(t[None] for t in leaves),
                                         is_causal=True, enable_gqa=True)[0]
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def phase_flash_backward() -> dict:
    """Phase 2's K4 backward (``flash_attention_bwd``): FA_BWD_CHECKS in
    the default config, each run twice for the same bits; then timed at
    the training shape beside the plain backward (the float32 recompute
    and its autograd, on the same bf16 tensors) and SDPA's backward.
    Returns the timing row."""
    t0 = time.perf_counter()
    bwd = _build.CUDA_KERNELS["flash_attention_bwd"]
    row = {}
    for problem, causal in FA_BWD_CHECKS:
        name = ("flash_attention_bwd_causal" if causal
                else "flash_attention_bwd_full")
        b = get_kernel(name)
        cfg = b.default_config()
        g = torch.Generator(device="cuda").manual_seed(sum(problem))
        bh, bhkv, s, d = problem
        args = [torch.randn(shape, generator=g, device="cuda")
                .to(torch.bfloat16) for shape in
                ((bh, s, d), (bhkv, s, d), (bhkv, s, d), (bh, s, d))]
        want = ref.flash_attention_bwd_ref_factory(causal)(
            *(t.float() for t in args))
        n0 = bwd.launches
        run = b.make(cfg, args_meta(*args))
        got, again = run(*args), run(*args)
        torch.cuda.synchronize()
        check(bwd.launches == n0 + 2, f"{name} {problem}: "
              f"{bwd.launches - n0} launches, want 2")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{name} {problem}: two runs differ")
        errs = {}
        for grad, a, w in zip(("dq", "dk", "dv"), got, want):
            a, w = a.double(), w.double()
            errs[grad] = {"rel_l2": float((a - w).norm() / w.norm()),
                          "row_l2": flash_attention.row_l2_error(a, w),
                          "max_abs_err": float((a - w).abs().max())}
            check(errs[grad]["rel_l2"] <= FA_BWD_REL_L2
                  and errs[grad]["row_l2"] <= FA_BWD_ROW_L2,
                  f"{name} {problem} {grad}: {errs[grad]}")
        print(f"check {name} {problem} (BH, BHkv, S, D) bfloat16 vs the "
              f"plain float32 gradient {json.dumps(errs)} (tol rel L2 "
              f"{FA_BWD_REL_L2:g}, row {FA_BWD_ROW_L2:g}); two runs "
              f"bit-identical ok config={json.dumps(cfg)}", flush=True)
        if s != 2048:
            continue
        plain = ref.flash_attention_bwd_ref_factory(causal)
        row = {"kernel": "flash_attention_bwd", "shape": list(problem),
               "dtype": "bfloat16", "config": cfg,
               "tuned_ms": time_ms(lambda: run(*args)),
               "plain_ms": time_ms(lambda: plain(*args), reps=3),
               "library_ms": time_ms(fa_bwd_sdpa(*args)),
               "max_abs_err": max(e["max_abs_err"] for e in errs.values())}
        row["bound_ms"], row["bound_by"] = bound(name, problem, "bfloat16",
                                                 cfg)
        row["bf16_peak_share"] = (
            b.make_workload(cfg, problem, "bfloat16").flops
            / (row["tuned_ms"] * 1e-3) / H100.flops_bf16)
        print("time " + json.dumps(row), flush=True)
        del args, want, got, again
    torch.cuda.empty_cache()
    print(f"phase 2 (K4's backward) took {time.perf_counter() - t0:.1f}s",
          flush=True)
    return row


def phase_main_path(wisdom: Path) -> tuple[dict, dict, dict]:
    """Phases 3-4, their wisdom kept under ``wisdom``. Returns the two
    examples' results and the CUDA kernels' launches."""
    _build.reset_launch_counts()
    runs0 = _build.NVCC_RUNS
    qs = quickstart.main(["--device", "cuda", "--max-evals", "20",
                          "--budget-seconds", "120",
                          "--wisdom-dir", str(wisdom / "quickstart")])
    check(qs["tiers"] == ("default", "exact"),
          f"quickstart tiers {qs['tiers']}, want ('default', 'exact')")
    mh = tune_microhh.main(["--device", "cuda", "--max-evals",
                            str(MICROHH_EVALS), "--budget-seconds", "120",
                            "--wisdom-dir", str(wisdom / "microhh")])
    builds = _build.NVCC_RUNS - runs0
    print(f"phases 3-4 nvcc runs: {builds}", flush=True)
    check(builds == 0, f"phases 3-4 built {builds} libraries: phase 1 must "
          f"build every config the two loops launch")
    for sc, tier, cfg in mh["selected"]:
        check(tier == "exact", f"{sc.key}: selected tier {tier}")
    for name, dtype, st, _ in mh["launched"]:
        check(st.tier not in ("exact", "default", "forced"),
              f"{name} 512^3 {dtype}: tier {st.tier} is not a fallback")
    counts = {k: _build.CUDA_KERNELS[k].launches for k in LOOP_KERNELS}
    bodies = {k: dict(_build.CUDA_KERNELS[k].body_launches)
              for k in STENCILS}
    print(f"main-path launches: {json.dumps(counts)}; stencils by body: "
          f"{json.dumps(bodies)}; by body and dtype: "
          f"{json.dumps(launches_by(STENCILS))}", flush=True)
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the main path")
    check(bodies["advec_u"].get("tile", 0) > 0,
          "advec_u did not launch its tile body on the main path")
    return qs, mh, counts


def launches_by(names) -> dict:
    """Each CUDA kernel's launches since the counts were last reset, by
    "body dtype"."""
    return {k: {f"{body} {dtype}": n for (body, dtype), n in sorted(
        _build.CUDA_KERNELS[k].body_dtype_launches.items(), key=str)}
            for k in names}


def both_diff_kernels(mh: dict, wisdom: Path) -> int:
    """diff_uvw at 512^3 float32 through a WisdomKernel forced into both
    fused variants of the config the fallback tier selected (its own body
    in each), each checked against the plain version. The main path's
    selection launches one of diff_uvw's two CUDA kernels through the
    launch path (the tuner launches both, but not through a WisdomKernel);
    this gives the other a launch span and a profile too. Run after the
    main path's counts are read, so they are not counted there. Returns
    the launches."""
    sel = next(st.config for name, dtype, st, _ in mh["launched"]
               if (name, dtype) == ("diff_uvw", "float32"))
    k = WisdomKernel(get_kernel("diff_uvw"), wisdom_dir=wisdom,
                     device_kind=current_device_kind())
    args = tune_microhh.launch_args("diff_uvw", (512,) * 3, "float32",
                                    torch.device("cuda"))
    want = ref.diff_uvw_ref(*args)
    for cfg in (sel | {"fuse_outputs": True},
                sel | {"fuse_outputs": False}):
        check(k.builder.space.is_valid(cfg), f"diff_uvw: {cfg} invalid")
        out = verify_outcome(k(*args, config=cfg), want, "float32")
        check(out.ok, f"diff_uvw 512^3 {cfg}: {out.error}")
        print(f"forced: diff_uvw 512^3 float32 as "
              f"{cuda_kernel('diff_uvw', cfg)} max_abs_err={out.max_err:.3e}"
              f" ok config={json.dumps(cfg)}", flush=True)
    del args, want
    return len(k.stats)


# -------------------------------------------------------------- telemetry

def instrument():
    """Turn on ``repro_torch.obs`` and one profiler that samples every
    launch: the ambient one (``KERNEL_LAUNCHER_PROF``), which every
    WisdomKernel and ServeEngine built from here on picks up, attached to
    ``ops``' kernels (built at import) too. Returns (registry, tracer,
    profiler)."""
    os.environ[PROF_ENV] = "1"
    reset_process_profiler()
    pr = process_profiler()
    pr.sample_every = 1
    for k in ops._ALL_KERNELS:
        k.attach_profiler(pr)
    obs_runtime.disable()
    reg, tr = obs_runtime.enable()
    return reg, tr, pr


def uninstrument() -> None:
    obs_runtime.disable()
    os.environ.pop(PROF_ENV, None)
    reset_process_profiler()
    for k in ops._ALL_KERNELS:
        k.attach_profiler(None)


def phase_telemetry(reg, tr, pr, stats: Counter, paths: list,
                    generations: int) -> dict:
    """Phase 7's reading of phases 3-5: counts, trace, profiles.
    ``paths`` names the runs in order, each with the number of profiles
    taken when it ended: ("main", n), ("forced", n), ("lm", n)."""
    snap = reg.snapshot()
    for name, n in sorted(stats.items()):
        got = snap["counters"].get(f"launch.count{{kernel={name}}}", 0)
        n_prof = sum(p.kernel == name for p in pr.profiles)
        check(got == n == n_prof, f"launch.count{{kernel={name}}} = {got},"
              f" {n} stats entries, {n_prof} profiles")
        print(f"telemetry launch.count{{kernel={name}}} = {got:g}: equals "
              f"the {n} WisdomKernel stats entries and {n_prof} profiles",
              flush=True)

    with tempfile.TemporaryDirectory(prefix="kl-trace-") as tmp:
        doc = load_trace(tr.save(Path(tmp) / "trace.json"))
    check(validate_trace(doc) == [], "trace failed validate_trace")
    spans = defaultdict(list)
    for e in doc["traceEvents"]:
        if e["name"] == "launch":
            spans[e["args"]["kernel"]].append(e)
    # One span and one profile a launch: the same (tier, scenario) pairs
    # for each builder, so the CUDA kernels the profiles' configs ran are
    # those the spans record.
    seen = set()
    for builder, evs in spans.items():
        profs = [p for p in pr.profiles if p.kernel == builder]
        got = Counter((e["args"]["tier"], e["args"]["scenario"])
                      for e in evs)
        want = Counter((p.tier, format_key(p.scenario_key())) for p in profs)
        check(got == want, f"{builder}: launch spans {dict(got)}, "
              f"profiles {dict(want)}")
        seen.update(cuda_kernel(builder, p.config) for p in profs)
    want_seen = set(LOOP_KERNELS + LM_KERNELS)   # phases 3-5 run no backward
    check(seen >= want_seen,
          f"no launch span for {sorted(want_seen - seen)}")
    arenas = sum(e["name"] == "serve.arena" for e in doc["traceEvents"])
    check(arenas == generations,
          f"{arenas} serve.arena spans, {generations} generations")
    print(f"telemetry trace: valid Chrome trace of "
          f"{len(doc['traceEvents'])} events, "
          f"{sum(map(len, spans.values()))} launch spans covering "
          f"{sorted(seen)}, {arenas} serve.arena spans for {generations} "
          f"generations", flush=True)

    groups = defaultdict(list)
    for i, p in enumerate(pr.profiles):
        kernel = (p.kernel if p.kernel == "serve.decode"
                  else cuda_kernel(p.kernel, p.config))
        path = next(name for name, end in paths if i < end)
        groups[(path, kernel)].append(p)
    # The main path's selection runs one diff_uvw kernel; the forced
    # launches run both.
    wants = ([("main", k) for k in ("advec_u", "matmul")]
             + [("forced", k) for k in STENCILS[1:]]
             + [("lm", k) for k in LM_KERNELS])
    for want in wants:
        check(want in groups, f"no profile of {want[1]} on the "
              f"{want[0]} path")
    check(any(("main", k) in groups for k in STENCILS[1:]),
          "no profile of a diff_uvw kernel on the main path")
    for (path, kernel), ps in sorted(groups.items()):
        fracs = [p.roofline_fraction for p in ps]
        check(all(0 < f <= MAX_ROOFLINE_FRACTION for f in fracs),
              f"{kernel} on the {path} path: roofline fractions {fracs}")
        p = ps[-1]
        print("profile " + json.dumps({
            "path": path, "kernel": kernel, "builder": p.kernel,
            "problem": list(p.problem_size), "dtype": p.dtype,
            "config": p.config, "tier": p.tier,
            "latency_us": p.latency_us, "compute_us": p.compute_us,
            "memory_us": p.memory_us, "bottleneck": p.bottleneck,
            "roofline_fraction": p.roofline_fraction, "profiles": len(ps),
            "bodies": dict(Counter(q.config.get("body") for q in ps)),
            "fraction_range": [min(fracs), max(fracs)]}), flush=True)
    return snap


def phase_export(kind: str, wisdom: Path, out: Path) -> None:
    """The paper's compile-time baseline: headers exported from the phase
    3-4 wisdom, each launched by StaticKernel against a WisdomKernel
    forced to the header's config, with both times, and what the
    WisdomKernel itself selects at that size."""
    cuda = torch.device("cuda")
    for name, wdir, shape in (
            ("advec_u", wisdom / "microhh", (512,) * 3),
            ("diff_uvw", wisdom / "microhh", (512,) * 3),
            ("matmul", wisdom / "quickstart", QS_MATMUL)):
        b = get_kernel(name)
        hdr = export_header(name, kind, wisdom_dir=wdir, out_dir=out)
        cfg = load_header(hdr)["config"]
        static = StaticKernel(b, hdr)
        wk = WisdomKernel(b, wisdom_dir=wdir, device_kind=kind)
        args = (matrices(*shape, "float32") if name == "matmul" else
                tune_microhh.launch_args(name, shape, "float32", cuda))
        got, want = static(*args), wk(*args, config=cfg)
        if name == "matmul":
            out_ = verify_outcome(got, want, "float32")
            check(out_.ok, f"StaticKernel {name}: {out_.error}")
            agree = f"max_abs_err={out_.max_err:.3e} {tolerance('float32')}"
        else:
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"StaticKernel {name} differs from the forced "
                  f"WisdomKernel")
            agree = "bit for bit"
        static_ms = time_ms(lambda: static(*args))
        wk_ms = time_ms(lambda: wk(*args, config=cfg))
        sel, tier = wk.select_config(tuple(shape), "float32")
        print(f"export {name} {'x'.join(map(str, shape))} float32: "
              f"StaticKernel vs WisdomKernel forced to the header's config "
              f"agree {agree}; StaticKernel {static_ms:.4f} ms, WisdomKernel"
              f" {wk_ms:.4f} ms; header config {json.dumps(cfg)}; the "
              f"WisdomKernel selects tier {tier} config {json.dumps(sel)}",
              flush=True)
        del args, got, want
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ LM slice

def lm_tokens(b: int, s: int, vocab: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=g, device="cuda")


def feed(model, params, tokens: torch.Tensor, max_seq: int) -> torch.Tensor:
    """The last logits of ``tokens`` fed one at a time through decode_step
    (plain decode attention: no flash launch)."""
    cache = model.init_cache(tokens.shape[0], max_seq)
    for i in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, cache, tokens[:, i:i + 1])
    return logits


def logit_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    g, w = got.to(torch.float64), want.to(torch.float64)
    return {"max_abs_err": float((g - w).abs().max()),
            "max_abs_ref": float(w.abs().max()),
            "rel_l2_err": float((g - w).norm() / w.norm()),
            "same_argmax": bool(torch.equal(g.argmax(-1), w.argmax(-1)))}


def lm_bf16_ok(err: dict) -> bool:
    """Check (c)'s acceptance of :func:`logit_errors` readings."""
    return (err["max_abs_err"] <= LM_BF16_TOL * max(1.0, err["max_abs_ref"])
            and err["rel_l2_err"] <= LM_BF16_TOL)


def n_elements(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_elements(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_elements(v) for v in tree)
    return tree.numel()


def timed(fn):
    """(result, host seconds) of ``fn`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_profile(fn, label: str, steps: int = 1, top: int = 6,
                   own: str = "", host_ops: bool = False) -> dict:
    """Run ``fn`` under torch.profiler: the device's kernel time per step,
    the window's host time per step (profiler overhead included), the
    kernels that took the most device time and, where ``own`` names a
    kernel function, that kernel's own device time per step. With
    ``host_ops`` the profiler also records host operators, and the host's
    wait in event syncs is read from them; they cost seconds to collect
    for a window of many small operators (minutes for ~10^5 launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        _, wall = timed(fn)
    # the program's spans (``repro_torch.*`` ranges) also show on the
    # device's timeline, as user annotations over their kernels: not kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3   # ms
    res = {"device_ms_per_step": busy / steps,
           "profiled_wall_ms_per_step": wall * 1e3 / steps,
           "profiler_s": time.perf_counter() - t0,
           "top": [(e.key[:70], round(e.self_device_time_total / 1e3
                                      / steps, 4)) for e in kernels[:top]]}
    if host_ops:
        # the host's wait in cudaEventSynchronize (WisdomKernel's
        # per-launch sync) inside the window
        res["event_sync_ms_per_step"] = sum(
            e.cpu_time_total for e in prof.key_averages()
            if e.key == "cudaEventSynchronize") / 1e3 / steps
    if own:
        res["own_ms_per_step"] = sum(
            e.self_device_time_total for e in kernels if own in e.key) \
            / 1e3 / steps
    if not kernels:
        print(f"profile {label}: the profiler saw no device kernels; "
              f"device time not measured", flush=True)
    else:
        print(f"profile {label}: device kernels {res['device_ms_per_step']:.2f}"
              f" ms/step, profiled host window "
              f"{res['profiled_wall_ms_per_step']:.2f} ms/step (the profiler "
              f"took {res['profiler_s']:.1f} s); top kernels "
              f"(ms/step): {json.dumps(res['top'])}", flush=True)
        if own:
            print(f"profile {label}: {own} {res['own_ms_per_step']:.3f} "
                  f"ms/step ({res['own_ms_per_step'] / busy * steps:.1%} "
                  f"of the device kernels' time)", flush=True)
    return res


def lm_f32_check(fa) -> dict:
    """(a) full width in float32 with 2 layers: prefill (flash kernel)
    against decode_step (plain attention) on one 256-token prompt."""
    cfg = replace(get_arch(LM_ARCH), n_layers=2, param_dtype="float32",
                  compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    tok = lm_tokens(1, 256, cfg.vocab, seed=1)
    n0 = fa.launches
    pre, _ = model.prefill(params, tok, model.init_cache(1, 256))
    check(fa.launches - n0 == cfg.n_layers,
          f"f32 prefill launched flash {fa.launches - n0} times, want 2")
    err = logit_errors(pre, feed(model, params, tok, 256))
    check(err["max_abs_err"] <= LM_F32_TOL * max(1.0, err["max_abs_ref"]),
          f"(a) f32 prefill vs decode: {err}")
    print(f"lm (a) {LM_ARCH} full width, 2 layers, float32, 256 tokens: "
          f"prefill (flash) vs decode_step {json.dumps(err)} tol "
          f"{LM_F32_TOL:g} x max(1, max|ref|) ok", flush=True)
    del model, params
    torch.cuda.empty_cache()
    return err


def phase_lm(lm_wisdom: Path) -> dict:
    """The LM slice on the card; returns what it measured. (d)'s wisdom
    is copied to ``lm_wisdom`` for phase 10."""
    fa = _build.CUDA_KERNELS["flash_attention"]
    out = {"f32": lm_f32_check(fa)}
    cfg = get_arch(LM_ARCH)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = timed(lambda: model.init(
        torch.Generator(device="cuda").manual_seed(0)))
    n_params = n_elements(params)
    print(f"lm {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters in {cfg.param_dtype} "
          f"(ArchConfig.n_params {cfg.n_params() / 1e9:.3f} B + QKV biases),"
          f" initialised on the card in {init_s:.1f} s", flush=True)

    # (b) full depth: prefill 4 x 2048, then 32 greedy decode steps
    tok = lm_tokens(LM_BATCH, LM_SEQ, cfg.vocab, seed=2)
    prefill_s = []
    for _ in range(3):          # the first is a warm-up
        cache = model.init_cache(LM_BATCH, LM_SEQ + LM_DECODE)
        n0, w0 = fa.launches, fa.body_launches.get("wgmma", 0)
        (logits, cache), sec = timed(lambda: model.prefill(params, tok,
                                                           cache))
        check(fa.launches - n0 == cfg.n_layers,
              f"prefill launched flash {fa.launches - n0} times, want "
              f"{cfg.n_layers}")
        check(fa.body_launches.get("wgmma", 0) - w0 == cfg.n_layers,
              f"prefill ran the wgmma body "
              f"{fa.body_launches.get('wgmma', 0) - w0} times, want "
              f"{cfg.n_layers}")
        prefill_s.append(sec)
    check(logits.shape == (LM_BATCH, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          "prefill logits not finite or of the wrong shape")
    nxt = logits[:, -1].argmax(-1, keepdim=True)

    def decode():
        nonlocal cache, nxt
        for _ in range(LM_DECODE):
            lg, cache = model.decode_step(params, cache, nxt)
            nxt = lg[:, -1].argmax(-1, keepdim=True)
        return lg

    lg, dec_s = timed(decode)
    check(cache["pos"] == LM_SEQ + LM_DECODE
          and bool(torch.isfinite(lg[..., :cfg.vocab]).all()),
          "decode logits not finite, or the cursor is wrong")
    out["prefill_ms"] = statistics.median(prefill_s[1:]) * 1e3
    out["prefill_tok_s"] = LM_BATCH * LM_SEQ / (out["prefill_ms"] / 1e3)
    out["decode_ms_per_step"] = dec_s / LM_DECODE * 1e3
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"lm (b) {LM_ARCH} bf16 x {cfg.n_layers} layers: prefill "
          f"{LM_BATCH} x {LM_SEQ} tokens in {out['prefill_ms']:.1f} ms "
          f"({out['prefill_tok_s']:.0f} tokens/s; runs "
          f"{[round(x * 1e3, 1) for x in prefill_s]} ms, the first a "
          f"warm-up), flash +{cfg.n_layers} launches per prefill, all "
          f"in the wgmma body; "
          f"{LM_DECODE} greedy decode steps at batch {LM_BATCH} in "
          f"{out['decode_ms_per_step']:.2f} ms/step; peak device memory "
          f"{out['peak_gb']:.1f} GB", flush=True)
    del cache, logits, lg

    # where the time goes: one prefill and 4 decode steps under the profiler
    state = {"cache": model.init_cache(LM_BATCH, LM_SEQ + 4)}

    def prefill_once():
        state["logits"], state["cache"] = model.prefill(params, tok,
                                                        state["cache"])

    def decode_4():
        for _ in range(4):
            nxt = state["logits"][:, -1].argmax(-1, keepdim=True)
            state["logits"], state["cache"] = model.decode_step(
                params, state["cache"], nxt)

    out["profile_prefill"] = device_profile(prefill_once, "prefill 4 x 2048",
                                            own="fa_wgmma_kernel")
    out["profile_decode"] = device_profile(decode_4, "decode batch 4",
                                           steps=4)
    busy = out["profile_decode"]["device_ms_per_step"]
    print(f"lm decode: device busy {busy:.2f} of "
          f"{out['decode_ms_per_step']:.2f} ms/step unprofiled "
          f"({busy / out['decode_ms_per_step']:.0%}); prefill: device busy "
          f"{out['profile_prefill']['device_ms_per_step']:.1f} of "
          f"{out['prefill_ms']:.1f} ms", flush=True)
    del state

    # (c) bf16 consistency: prefill vs decode_step on 256 tokens
    tok_c = lm_tokens(1, 256, cfg.vocab, seed=3)
    pre, _ = model.prefill(params, tok_c, model.init_cache(1, 256))
    err = logit_errors(pre, feed(model, params, tok_c, 256))
    check(lm_bf16_ok(err), f"(c) bf16 prefill vs decode: {err}")
    out["bf16"] = err
    print(f"lm (c) bf16 x {cfg.n_layers} layers, 256 tokens: prefill "
          f"(flash) vs decode_step {json.dumps(err)} tol {LM_BF16_TOL:g} "
          f"(max abs, x max(1, max|ref|); and relative L2) ok", flush=True)

    # (d) capture the prefill's attention launch, tune it, select "exact"
    with tempfile.TemporaryDirectory(prefix="kl-lm-") as tmp:
        one = build_model(replace(cfg, n_layers=1))
        with quickstart._env(**{CAPTURE_ENV: "flash_attention_causal",
                                CAPTURE_DIR_ENV: f"{tmp}/captures"}):
            one.prefill({**params, "layers": params["layers"][:1]}, tok,
                        one.init_cache(LM_BATCH, LM_SEQ))
        caps = list_captures(f"{tmp}/captures")
        check(len(caps) == 1, f"{len(caps)} captures, want 1")
        res = tune_capture(caps[0], current_device_kind(), strategy="bayes",
                           max_evals=8, time_budget_s=120,
                           wisdom_dir=f"{tmp}/wisdom", device="cuda")
        with quickstart._env(**{WISDOM_DIR_ENV: f"{tmp}/wisdom"}):
            ops.reload_wisdom()
            tiers0 = dict(ops.fa_causal_kernel.tier_counts)
            _, sec = timed(lambda: model.prefill(
                params, tok, model.init_cache(LM_BATCH, LM_SEQ)))
            tiers = {t: n - tiers0.get(t, 0)
                     for t, n in ops.fa_causal_kernel.tier_counts.items()
                     if n != tiers0.get(t, 0)}
        ops.reload_wisdom()
        shutil.copytree(f"{tmp}/wisdom", lm_wisdom)
    check(tiers == {"exact": cfg.n_layers},
          f"tuned prefill selected {tiers}, want exact x {cfg.n_layers}")
    out["tuned"] = res.best_config
    out["tuned_prefill_ms"] = sec * 1e3
    print(f"lm (d) captured {caps[0].name}, tuned by wall clock: best "
          f"{res.best_score_us:.1f} us after {len(res.evaluations)} evals -> "
          f"{res.best_config} (body {fa_body(res.best_config, 'bfloat16')});"
          f" next prefill selected {tiers} in {sec * 1e3:.1f} ms",
          flush=True)

    # (e) serve: token mode, 8 requests on 4 slots
    eng = ServeEngine(model, params, n_slots=4, max_seq=256, mode="token")
    rng = np.random.default_rng(0)
    for rid in range(8):
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(8, 33)),
                              dtype=np.int32)
        check(eng.submit(Request(rid, prompt, max_new_tokens=16)),
              f"request {rid} rejected")
    rep, sec = timed(eng.run)
    check(rep.requests_completed == 8 and rep.mode == "token"
          and all(len(t) == 16 for t in rep.values()),
          f"serve: {rep.to_json()}")
    out["serve"] = rep.to_json() | {"seconds": sec,
                                    "tok_s": 8 * 16 / sec}
    print(f"lm (e) ServeEngine token mode, 4 slots, max_seq 256: "
          f"{rep.requests_completed} requests, {rep.steps} steps, occupancy "
          f"{rep.occupancy}, {8 * 16} tokens in {sec:.2f} s "
          f"({8 * 16 / sec:.1f} generated tokens/s)", flush=True)
    del model, params, eng
    torch.cuda.empty_cache()
    return out


def phase_times(qs: dict, mh: dict) -> dict:
    rows = {}
    tuned_256 = {(sc.kernel, sc.dtype): res.best_config
                 for sc, res in mh["tuned"]}
    sel_512 = {(name, dtype): st.config for name, dtype, st, _ in
               mh["launched"]}
    for dtype in DTYPES:
        for g, chosen in ((256, tuned_256), (512, sel_512)):
            shape = (g, g, g)
            args = stencil_args("diff_uvw_fused", shape, dtype)
            a_cfg = chosen[("advec_u", dtype)]
            d_cfg = chosen[("diff_uvw", dtype)]
            rows[("advec_u", g, dtype)] = timing_row(
                "advec_u", shape, dtype,
                {"default": kernel_cfg("advec_u", {}), "tuned": a_cfg,
                 "ldg": kernel_cfg("advec_u", LDG_CONFIGS[0]),
                 "tile": kernel_cfg("advec_u", TILE_LDG_BLOCK)},
                [*args[:3], args[4]])
            for name in STENCILS[1:]:
                rows[(name, g, dtype)] = timing_row(
                    name, shape, dtype,
                    {"default": kernel_cfg(name, {}),
                     "tuned": d_cfg | {"fuse_outputs":
                                       name == "diff_uvw_fused"},
                     "ldg": kernel_cfg(name, LDG_CONFIGS[0]),
                     "tile": kernel_cfg(name, TILE_LDG_BLOCK),
                     "tile_default": kernel_cfg(name, TILE_DEFAULT)}, args)
            fused, single = (rows[(n, g, dtype)] for n in STENCILS[1:])
            print("time K2a vs K2b a call " + json.dumps({
                "shape": list(shape), "dtype": dtype} | {
                f"{label}_ms": [fused[f"{label}_ms"], single[f"{label}_ms"],
                                fused[f"{label}_ms"] / single[f"{label}_ms"]]
                for label in ("tile", "tile_default")} | {
                "bound_ms": [fused["bound_ms"], single["bound_ms"]]}) +
                  " ([K2a, K2b, K2a / K2b])", flush=True)
            del args
    print(f"time stencils: default and tuned as selected (tuned K2a and "
          f"K2b: the tuned config in each fused variant); ldg and tile at "
          f"one block ({TILE_LDG_BLOCK['block_size_x']} x "
          f"{TILE_LDG_BLOCK['block_size_y']}); tile_default "
          f"{json.dumps(TILE_DEFAULT)} (advec_u's default)", flush=True)
    res = qs["result"]
    rows[("matmul", 512, "float32")] = timing_row(
        "matmul", QS_MATMUL, "float32",
        {"default": kernel_cfg("matmul", {}), "tuned": res.best_config},
        [qs["a"], qs["b"]])
    matmul_sweep([qs["a"], qs["b"]], res.best_config)
    rows[("matmul", 8192, "float32")] = timing_row(
        "matmul", BIG_MATMUL, "float32", {"default": kernel_cfg("matmul", {})},
        matrices(*BIG_MATMUL, "float32"))
    for shape in (QS_MATMUL, BIG_MATMUL):
        rows[("matmul", shape[0], "bfloat16")] = timing_row(
            "matmul", shape, "bfloat16",
            {"default": kernel_cfg("matmul", {})} | {
                label: kernel_cfg("matmul", u)
                for label, u in MATMUL_TIMED.items()},
            matrices(*shape, "bfloat16"))
    torch.cuda.empty_cache()
    return rows


def matmul_sweep(args, tuned: dict) -> None:
    """Every float32 config of the space on the quickstart's operands,
    median of 5, fastest first; and where the tuner's pick ranks."""
    space = get_kernel("matmul").space
    sweep = sorted(((c, time_ms(calls("matmul", c, args)[0], reps=5))
                    for c in space.enumerate()), key=lambda x: x[1])
    SWEEPS["matmul"] = sweep
    print("sweep matmul float32 " + json.dumps(
        [[c["block_m"], c["block_n"], c["block_k"], c["stages"],
          c["split_k"], c["grid_order"], round(ms, 4)] for c, ms in sweep])
          + " ([block_m, block_n, block_k, stages, split_k, grid_order, ms])",
          flush=True)
    rank = next(i for i, (c, _) in enumerate(sweep) if c == tuned)
    print(f"sweep matmul float32: {len(sweep)} configs, fastest "
          f"{sweep[0][1]:.4f} ms, slowest {sweep[-1][1]:.4f} ms; the tuned "
          f"config ranks {rank + 1} at {sweep[rank][1]:.4f} ms", flush=True)


def phase_lm_times(lm: dict) -> dict:
    """K4 at the shape the LM prefill gives it: (B*H, B*Hkv, S, D)."""
    cfg = get_arch(LM_ARCH)
    shape = (LM_BATCH * cfg.n_heads, LM_BATCH * cfg.n_kv_heads, LM_SEQ,
             cfg.d_head)
    args = qkv(*shape, "bfloat16")
    row = timing_row(
        "flash_attention_causal", shape, "bfloat16",
        {"default": kernel_cfg("flash_attention_causal", {}),
         "tuned": lm["tuned"],
         "mma": kernel_cfg("flash_attention_causal", FA_MMA)}, args)
    print(f"time flash_attention_causal bodies: default "
          f"{fa_body(kernel_cfg('flash_attention_causal', {}), 'bfloat16')},"
          f" tuned {fa_body(lm['tuned'], 'bfloat16')}, mma "
          f"{fa_body(kernel_cfg('flash_attention_causal', FA_MMA), 'bfloat16')}",
          flush=True)
    sweep = [(cfg, time_ms(calls("flash_attention_causal", cfg, args)[0],
                           reps=5))
             for cfg in get_kernel("flash_attention_causal").space.enumerate()]
    sweep.sort(key=lambda x: x[1])
    SWEEPS["flash_attention_causal"] = sweep
    print("sweep flash_attention_causal " + json.dumps(
        [[c["block_q"], c["block_k"], c["threads"], fa_body(c, "bfloat16"),
          round(ms, 4)] for c, ms in sweep])
          + " ([block_q, block_k, threads, body, ms])", flush=True)
    return row


# ------------------------------------------------------ online tuning (8)

#: The 512^3 float32 scenarios phase 4 launches through a fallback tier.
ONLINE_SCENARIOS = ("advec_u", "diff_uvw")
ONLINE_GRID = (512, 512, 512)
ONLINE_MAX_LAUNCHES = 400
#: The config phase 8 promotes by hand: K2b's tile body at advec_u's tile
#: default (64 x 4, strip 128, 2 blocks an SM), over diff_uvw's ldg default
#: run single-field (2.2615 against 3.0829 ms a call on the H100,
#: PERF.md §6).
K2B_TILE = kernel_cfg("diff_uvw_single", TILE_DEFAULT)
K2B_LDG = kernel_cfg("diff_uvw_single", {})
#: A spawned child's payload ceiling on the card (its interpreter, imports
#: and CUDA context come first and do not count); the hang child's is
#: short, since reaching it is the check. Each CUDA child may take this
#: share of the card's memory.
CHILD_TIMEOUT_S, HANG_TIMEOUT_S = 120.0, 5.0
CHILD_DEVICE_FRACTION = 0.02
#: Configs in phase 8's bracket of live trials (the tuner's default is 8):
#: each is built by nvcc on the launching thread at its first trial.
ONLINE_BRACKET = 4


def _ranks(xs) -> np.ndarray:
    """Ranks of ``xs`` from 1, ties sharing their mean rank."""
    xs = np.asarray(xs, dtype=np.float64)
    order = np.argsort(xs, kind="stable")
    r = np.empty(len(xs))
    r[order] = np.arange(1, len(xs) + 1)
    for v in np.unique(xs):
        tie = xs == v
        r[tie] = r[tie].mean()
    return r


def spearman(xs, ys) -> float:
    """Spearman's rank correlation of two equal-length sequences."""
    rx, ry = _ranks(xs), _ranks(ys)
    if rx.std() == 0 or ry.std() == 0:
        return float("nan")
    return float(np.corrcoef(rx, ry)[0, 1])


def model_us(name: str, shape, dtype: str, cfg: dict) -> tuple[float, float]:
    """The cost model's time for CUDA kernel ``name`` in ``cfg``: as the
    online tuner's screening scores it (``CostModelEvaluator`` on the
    gpu-h100 spec, hashed noise included), and without the noise."""
    b = builder_of(name)
    ev = CostModelEvaluator(b, tuple(shape), dtype, H100, verify="none")
    w = b.make_workload(cfg, tuple(shape), dtype)
    return (ev(cfg).score_us,
            CostModel(H100, noise_sigma=0).time(w, dtype) * 1e6)


def online_scenario(name: str, wisdom: Path, reg) -> dict:
    """Phase 8 item 1 for ``name`` at 512^3 float32: traffic through a
    WisdomKernel with ``enable_online_tuning(objective="wallclock")`` until
    its scenario's bracket finishes; the outcome is checked and timed."""
    cuda = torch.device("cuda")
    k = WisdomKernel(get_kernel(name), wisdom_dir=wisdom,
                     device_kind=current_device_kind())
    svc = enable_online_tuning(k, objective="wallclock", seed=0,
                               bracket_size=ONLINE_BRACKET)
    DEMAND[name] = svc.tracker
    args = tune_microhh.launch_args(name, ONLINE_GRID, "float32", cuda)
    activated_at = None
    for i in range(1, ONLINE_MAX_LAUNCHES + 1):
        k(*args)
        state = svc.state(ONLINE_GRID, "float32")
        if state is not None and activated_at is None:
            activated_at = i
        if state is not None and state.finished:
            break
    check(activated_at == 3 and all(s.tier in MISS_TIERS
                                    for s in k.stats[:3]),
          f"{name}: activated at launch {activated_at}, tiers "
          f"{[s.tier for s in k.stats[:3]]}; want the third miss")
    incumbent = dict(k.stats[0].config)
    check(isinstance(state.evaluator, CostModelEvaluator)
          and state.evaluator.device.kind == "gpu-h100"
          and state.scheduler.screens > 0,
          f"{name}: screening did not run the cost model on gpu-h100")
    check(state.finished and state.scheduler.winner() is not None,
          f"{name}: no finished bracket in {len(k.stats)} launches "
          f"({[e[0] for e in svc.events]})")
    outcome = svc.events[-1][0]
    check(outcome in ("promote", "keep-incumbent"),
          f"{name}: bracket ended in {outcome!r}: {svc.events[-1][2]}")
    trials = [s for s in k.stats if s.tier == "trial"]
    built = [s for s in trials if not s.cached]
    res = {"kernel": name, "outcome": "promoted" if outcome == "promote"
           else "kept", "launches": len(k.stats),
           "trial_launches": len(trials), "cold_trials": state.cold_trials,
           "screens": svc.meter.screens,
           "activated_at_launch": activated_at,
           "online_overhead_us": reg.counter("online.overhead_us",
                                             kernel=name).value,
           "trial_builds": len(built),
           "trial_compile_s": sum(s.compile_s for s in built),
           "trial_load_s": sum(s.load_s for s in built),
           "trial_launch_ms_median": statistics.median(
               s.launch_s * 1e3 for s in trials),
           "incumbent": incumbent}
    by_cfg: dict[str, list[float]] = {}
    for st in trials:
        by_cfg.setdefault(json.dumps(st.config, sort_keys=True), []).append(
            round(st.launch_s * 1e3, 4))
    # each trial config's launch times in order (its first launch built and
    # loaded it, and is not scored), and the incumbent's mean, from the
    # WisdomKernel's own events
    res["trial_launch_ms"] = list(by_cfg.values())
    res["incumbent_launch_ms_mean"] = statistics.mean(
        s.launch_s * 1e3 for s in k.stats if s.tier != "trial")
    winner, won_us, n = state.scheduler.winner()
    res["bracket_winner"] = {"config": winner, "mean_launch_ms":
                             won_us / 1e3, "measurements": n}
    if outcome == "promote":
        out = k(*args)
        st = k.stats[-1]
        rec = svc.promotions()[0].record
        check(st.tier == "exact" and st.config == rec.config,
              f"{name}: the launch after the promotion ran tier {st.tier}")
        check(st.cached and st.compile_s == 0.0 and st.load_s == 0.0,
              f"{name}: the swap launch compiled ({st.compile_s:.3f} s)")
        check(rec.provenance.get("online") is True
              and rec.provenance.get("strategy") == "online"
              and rec.oracle_verified() is not None,
              f"{name}: promoted record provenance {rec.provenance}")
        want = (ref.advec_u_ref(*args) if name == "advec_u"
                else ref.diff_uvw_ref(*args))
        v = verify_outcome(out, want, "float32")
        check(v.ok, f"{name}: promoted config at 512^3: {v.error}")
        res |= {"promoted": rec.config, "swap_compile_s": st.compile_s,
                "verified": rec.oracle_verified(),
                "max_abs_err": v.max_err}
        chosen = rec.config
    else:
        print(f"online {name} 512^3 float32: the incumbent was kept "
              f"(bracket winner {json.dumps(winner)})", flush=True)
        chosen = winner
    # times from chip_smoke's own clock: the median of 10 launches, each
    # after an L2 flush, by CUDA events
    for label, cfg in (("incumbent", incumbent), ("chosen", chosen)):
        res[f"{label}_ms"] = time_ms(calls(cuda_kernel(name, cfg), cfg,
                                           args)[0])
    res["chosen_over_incumbent"] = res["chosen_ms"] / res["incumbent_ms"]
    del args
    torch.cuda.empty_cache()
    print("online " + json.dumps(res), flush=True)
    return res


def deterministic_promotion(wisdom: Path, broadcast=None,
                            label: str = "online") -> dict:
    """Phase 8 item 2: offer K2b's tile config over the ldg default to the
    promotion pipeline by hand, timed here; the next launch selects it in
    tier exact with nothing to compile, and its output holds. Phase 10
    item 5 repeats it with a ``broadcast`` hook."""
    cuda = torch.device("cuda")
    args = tune_microhh.launch_args("diff_uvw", ONLINE_GRID, "float32",
                                    cuda)
    tile_ms = time_ms(calls("diff_uvw_single", K2B_TILE, args)[0])
    ldg_ms = time_ms(calls("diff_uvw_single", K2B_LDG, args)[0])
    k = WisdomKernel(get_kernel("diff_uvw"), wisdom_dir=wisdom,
                     device_kind=current_device_kind())
    pipe = PromotionPipeline(k, broadcast=broadcast)
    promo = pipe.promote(k.device_kind, ONLINE_GRID, "float32", K2B_TILE,
                         score_us=tile_ms * 1e3,
                         incumbent_score_us=ldg_ms * 1e3, n_measurements=10,
                         evals=2, objective="wallclock",
                         meta=args_meta(*args))
    check(promo is not None, f"K2b tile {tile_ms:.4f} ms over ldg "
          f"{ldg_ms:.4f} ms was not promoted ({pipe.rejections})")
    gate_device = pipe.oracle._oracles[
        ("diff_uvw", ONLINE_GRID, "float32", "cuda:0")].args[0].device
    check(gate_device.type == "cuda", "the gate did not check on the card")
    out = k(*args)
    st = k.stats[-1]
    check(st.tier == "exact" and st.config == K2B_TILE,
          f"K2b: the next launch ran tier {st.tier} {st.config}")
    check(st.cached and st.compile_s == 0.0,
          f"K2b: the swap launch compiled ({st.compile_s:.3f} s)")
    v = verify_outcome(out, ref.diff_uvw_ref(*args), "float32")
    check(v.ok, f"K2b tile at 512^3 after promotion: {v.error}")
    res = {"tile_ms": tile_ms, "ldg_ms": ldg_ms, "tier": st.tier,
           "compile_s": st.compile_s, "max_abs_err": v.max_err,
           "verified": promo.record.oracle_verified(),
           "broadcasts": pipe.broadcasts}
    del args
    torch.cuda.empty_cache()
    print(f"{label} deterministic promotion K2b " + json.dumps(res),
          flush=True)
    return res


def gate_on_card() -> dict:
    """Phase 8 item 3: the gate checks on the card; it passes the sound K1
    tile config and vetoes the faulty kernel's wrong one."""
    gate = OracleGate(device="cuda")
    clear_verdict_cache()
    k1 = gate.check("advec_u", TILE_DEFAULT, (128, 128, 128), "float32")
    check(k1.ok, f"gate: K1 tile default {k1.status} {k1.detail}")
    oracle = gate._oracles[("advec_u", (128, 128, 128), "float32", "cuda")]
    check(all(a.device.type == "cuda" for a in oracle.args),
          "gate: the K1 probe did not move to the card")
    faulty = make_faulty_kernel()
    register(faulty)
    try:
        honest = gate.check(faulty, {"scale": 1, FAULT_PARAM: "none"},
                            (256, 256), "float32")
        wrong = gate.check(faulty, {"scale": 1, FAULT_PARAM: "wrong"},
                           (256, 256), "float32")
    finally:
        unregister(faulty.name)
        clear_verdict_cache()
    check(honest.ok and wrong.status == "numerics-mismatch"
          and not gate.allows(wrong),
          f"gate: faulty kernel honest {honest.status}, wrong "
          f"{wrong.status}")
    res = {"k1_tile": k1.status, "k1_max_abs_err": k1.max_err,
           "faulty_honest": honest.status, "faulty_wrong": wrong.status,
           "faulty_wrong_max_abs_err": wrong.max_err}
    print("online gate on the card " + json.dumps(res), flush=True)
    return res


def sandbox_on_card() -> dict:
    """Phase 8 item 4: each fault mode in a spawned child holding a CUDA
    context, a child that loses its context to a device-side assertion
    and one that builds and times K1 from the on-disk library, all at
    once; afterwards this process still launches K1."""
    def settings(mode):
        return SandboxSettings(
            timeout_s=HANG_TIMEOUT_S if mode == "hang" else CHILD_TIMEOUT_S,
            device_memory_fraction=CHILD_DEVICE_FRACTION)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        modes = pool.submit(run_fault_modes, EXPECTED_VERDICTS, settings,
                            device="cuda")
        assert_run = pool.submit(sandboxed_call, functools.partial(
            device_assert, "cuda"), settings("assert"))
        trial_run = pool.submit(sandboxed_call, functools.partial(
            KernelTrial("advec_u", (128, 128, 128), "float32"),
            TILE_DEFAULT), settings("trial"))
        runs, (lost, _), (trial, payload) = (
            modes.result(), assert_run.result(), trial_run.result())
    res = {}
    for mode, want in EXPECTED_VERDICTS.items():
        result, verdict = runs[mode]
        res[mode] = {"status": verdict.status,
                     "exit_cause": verdict.exit_cause,
                     "wall_s": round(verdict.wall_s, 2)}
        check(verdict.status == want and result.feasible == (mode == "none"),
              f"sandbox: {mode} in a CUDA child gave {verdict.status} "
              f"({verdict.detail}); want {want}")
    check(res["segv"]["exit_cause"] == "signal:11",
          f"sandbox: segv exit cause {res['segv']['exit_cause']}")
    check(lost.status == "crash" and "CUDA" in lost.detail,
          f"sandbox: device-side assert gave {lost.status} {lost.detail}")
    res["device_assert"] = {"status": lost.status,
                            "detail": lost.detail[:120]}
    check(trial.ok and payload.feasible and payload.verified,
          f"sandbox: K1 trial in a child gave {trial.status} "
          f"{trial.detail} {payload}")
    res["k1_trial_in_child_us"] = payload.score_us
    args = stencil_args("advec_u", (128, 128, 128), "float32")
    after = compare("advec_u", TILE_DEFAULT, args, "float32",
                    "after children")
    res["parent_k1_after_max_abs_err"] = after["max_abs_err"]
    res["seconds"] = round(time.perf_counter() - t0, 1)
    print("online sandbox on the card " + json.dumps(res), flush=True)
    return res


def model_rank_correlation() -> dict:
    """Phase 8 item 5: Spearman's rank correlation between the cost model
    and phase 6's CUDA-event times of the stencils at 512^3, within each
    (kernel, dtype) and over all of them."""
    rows = {}
    for name, shape, dtype, cfg, ms in TIMED:
        if name in STENCILS and shape == ONLINE_GRID:
            rows.setdefault((name, dtype), {})[
                json.dumps(cfg, sort_keys=True)] = (cfg, ms)
    res, pooled = {}, ([], [], [])
    for (name, dtype), by_cfg in sorted(rows.items()):
        ms = [m for _, m in by_cfg.values()]
        mod = [model_us(name, ONLINE_GRID, dtype, c)
               for c, _ in by_cfg.values()]
        res[f"{name} {dtype}"] = {
            "n": len(ms), "rho": spearman([m[0] for m in mod], ms),
            "rho_noise_free": spearman([m[1] for m in mod], ms)}
        pooled[0].extend(ms)
        pooled[1].extend(m[0] for m in mod)
        pooled[2].extend(m[1] for m in mod)
    res["all"] = {"n": len(pooled[0]), "rho": spearman(pooled[1], pooled[0]),
                  "rho_noise_free": spearman(pooled[2], pooled[0])}
    print("online cost model vs phase 6 at 512^3, Spearman " +
          json.dumps(res), flush=True)
    return res


def phase_online(wisdom: Path, tmp: Path) -> dict:
    """Phase 8: online tuning on the card, on copies of phase 4's wisdom,
    with obs enabled."""
    t8 = time.perf_counter()
    obs_runtime.disable()
    reg, _ = obs_runtime.enable()
    try:
        out = {}
        for name in ONLINE_SCENARIOS:
            copy = tmp / f"online-{name}"
            shutil.copytree(wisdom, copy)
            out[name] = online_scenario(name, copy, reg)
        copy = tmp / "online-k2b"
        shutil.copytree(wisdom, copy)
        out["k2b_promotion"] = deterministic_promotion(copy)
        out["gate"] = gate_on_card()
        out["sandbox"] = sandbox_on_card()
        out["spearman"] = model_rank_correlation()
    finally:
        obs_runtime.disable()
    out["seconds"] = time.perf_counter() - t8
    print(f"phase 8 (online tuning) took {out['seconds']:.1f}s", flush=True)
    return out


# --------------------------------------- recorded spaces and transfer (9)

#: The device kinds phase 9 transfers from onto the card's, each space
#: recorded there by the cost model (host-side, deterministic).
TRANSFER_SOURCES = ("gpu-a100", "gpu-a4000")


def lm_flash_shape() -> tuple[int, int, int, int]:
    """(B*H, B*Hkv, S, D) of the LM slice's prefill attention."""
    cfg = get_arch(LM_ARCH)
    return (LM_BATCH * cfg.n_heads, LM_BATCH * cfg.n_kv_heads, LM_SEQ,
            cfg.d_head)


def record_on_card(name: str, problem, dtype: str) -> SpaceDataset:
    """Phase 9 items 1-2: every config of ``name``'s space at ``problem``
    by wall clock on the card (each config checked against the plain
    version, its first launch unscored, the best of 5 after L2 flushes),
    ranked against phase 6's sweep of the same configs."""
    builder = get_kernel(name)
    t = time.perf_counter()
    ds = record_space(builder, problem, dtype, current_device_kind(),
                      objective="wallclock")
    secs = time.perf_counter() - t
    n_valid = builder.space.valid_cardinality()
    check(len(ds) == n_valid and ds.objective == "wallclock",
          f"record {name}: {len(ds)} entries of {n_valid} configs")
    feas = ds.feasible()
    check(feas and all(e.score_us > 0 and e.profile for e in feas),
          f"record {name}: feasible entries without a time or a profile")
    RECORDINGS[name] = ds
    best = ds.best()
    default = ds.lookup(builder.default_config())
    sweep = {json.dumps(c, sort_keys=True): ms
             for c, ms in SWEEPS[name]}
    pairs = [(e.score_us, sweep[json.dumps(e.config, sort_keys=True)])
             for e in feas]
    rho = spearman([a for a, _ in pairs], [b for _, b in pairs])
    res = {"kernel": name, "problem": list(problem), "dtype": dtype,
           "entries": len(ds), "feasible": len(feas),
           "best": best.config, "best_us": best.score_us,
           "default_us": default.score_us if default.feasible else None,
           "spearman_vs_phase6_sweep": rho, "n_ranked": len(pairs),
           "seconds": secs}
    print("record " + json.dumps(res), flush=True)
    if name.startswith("flash"):
        for e in sorted(feas, key=lambda e: e.score_us):
            print(f"record {name} {json.dumps(e.config)} body="
                  f"{fa_body(e.config, dtype)} {e.score_us:.3f}us",
                  flush=True)
    else:
        print(f"record {name} " + json.dumps(
            [[e.config[k] for k in builder.space.names]
             + [round(e.score_us, 3)]
             for e in sorted(feas, key=lambda e: e.score_us)])
              + f" ({list(builder.space.names)} + [us])", flush=True)
    return ds


def replay(ds: SpaceDataset) -> dict:
    """Phase 9 item 4: the recording replayed on the host: every strategy
    (seeded, twice: byte-identical reports), the fitted surrogate with and
    without profile features, the re-rank gate and the class."""
    reports = [dump_report(compare_strategies([ds])) for _ in range(2)]
    check(reports[0] == reports[1],
          f"compare over {ds.name()}: two runs differ")
    rep = json.loads(reports[0])
    out = {"dataset": ds.name(), "budget": rep["budget"],
           "seeds": rep["seeds"], "check": "PASS" if rep["pass"] else "FAIL",
           "final_fraction": {}, "threshold": {}}
    for s in rep["datasets"][0]["strategies"]:
        out["final_fraction"][s["strategy"]] = s["final_fraction"]
        out["threshold"][s["strategy"]] = s["threshold"]
    out["fit_quality"] = fit_from_dataset(ds).fit_quality()
    out["fit_quality_profile"] = fit_from_dataset(
        ds, profile_features=True).fit_quality()
    train = len(ds.feasible()[::DEFAULT_TRAIN_EVERY])
    if train >= 3:
        r = surrogate_rerank(ds)
        out["rerank"] = {row["surrogate"]: row["fraction_at"]
                         for row in r["surrogates"]}
        out["rerank_gate"] = rerank_gate(r) or "PASS"
    else:
        out["rerank"] = (f"not run: every {DEFAULT_TRAIN_EVERY}th of "
                         f"{len(ds.feasible())} feasible entries gives "
                         f"{train} to train on, the fit needs 3")
    c = classify_dataset(ds)
    out["class"] = {k: c[k] for k in ("bottleneck", "best_us",
                                      "best_roofline_fraction",
                                      "distribution")}
    print("replay " + json.dumps(out), flush=True)
    return out


def transfer_onto_card(truth: SpaceDataset, store: DatasetStore) -> dict:
    """Phase 9 item 5: the same scenario recorded by the cost model on
    each source kind, transferred onto the card's kind and scored against
    the card's recording; with the fraction the top-ranked prediction
    would reach if the serving gate let it through."""
    builder = get_kernel(truth.kernel)
    out = {}
    for src in TRANSFER_SOURCES:
        source = record_space(builder, truth.problem_size, truth.dtype, src)
        store.save(source)
        rep = holdout_report(source, truth)
        result = transfer_scenario(source, truth.device_kind)
        top = result.best()
        row = {"confidence": rep["confidence"],
               "components": rep["components"],
               "transfer": [rep["transfer"]["tier"],
                            rep["transfer"]["fraction"]],
               "fallback": [rep["fallback"]["tier"],
                            rep["fallback"]["fraction"]],
               "default": rep["default"]["fraction"],
               "top_prediction": top.config if top else None,
               "top_prediction_fraction": (
                   fraction_of_optimum(truth, top.config) if top else None),
               "gate": TRANSFER_MIN_CONFIDENCE}
        check(0 < rep["components"]["similarity"] <= 1,
              f"transfer {src}: similarity {rep['components']['similarity']}")
        print(f"transfer {truth.kernel} {src} -> {truth.device_kind} "
              + json.dumps(row), flush=True)
        out[src] = row
    return out


def write_paths(tmp: Path, store: DatasetStore) -> dict:
    """Phase 9 item 6: tune_kernel's dataset, a CUDA child's recorded
    entries, and ``transfer predict`` writing through a WisdomStore."""
    res = {}
    # (a) the quickstart scenario tuned with record_dataset=
    builder = get_kernel("matmul")
    t = tune_kernel(builder, QS_MATMUL, "float32", current_device_kind(),
                    strategy="random", max_evals=8, time_budget_s=None,
                    wisdom_dir=tmp / "w9", record_dataset=tmp / "ds9")
    ds = DatasetStore(tmp / "ds9").load_for(
        "matmul", current_device_kind(), QS_MATMUL, "float32")
    want = {ds.key_for(e.config) for e in t.evaluations}
    check(ds is not None and set(ds.evaluations) == want
          and all(ds.lookup(e.config).score_us == e.score_us
                  for e in t.evaluations if e.feasible),
          "tune_kernel(record_dataset=): entries are not the session's")
    res["tune_record_dataset"] = {"evaluations": len(t.evaluations),
                                  "entries": len(ds)}
    # (b) SandboxedEvaluator(record_to=) with CUDA children
    rec = SpaceDataset("matmul", builder.space, QS_MATMUL, "float32",
                       current_device_kind(), objective="wallclock")
    ev = SandboxedEvaluator(KernelTrial("matmul", QS_MATMUL, "float32"),
                            SandboxSettings(
                                timeout_s=CHILD_TIMEOUT_S,
                                device_memory_fraction=CHILD_DEVICE_FRACTION),
                            record_to=rec)
    cfgs = [builder.default_config()]
    cfgs.append(next(c for c, _ in SWEEPS["matmul"] if c != cfgs[0]))
    with ThreadPoolExecutor(max_workers=len(cfgs)) as pool:
        results = list(pool.map(ev, cfgs))
    check(all(r.feasible and r.verified for r in results)
          and len(rec) == len(cfgs)
          and all(rec.lookup(c).feasible and not rec.lookup(c).verdict
                  for c in cfgs),
          f"SandboxedEvaluator(record_to=): {results} {rec.to_doc()}")
    res["sandbox_record_to"] = {
        "entries": len(rec),
        "us": [rec.lookup(c).score_us for c in cfgs],
        "verdicts": [v.status for _, v in ev.verdicts]}
    # (c) transfer predict into a WisdomStore beside the source's measured
    # record; the store's select on the card's scenario
    src = store.path_for("matmul", TRANSFER_SOURCES[0], QS_MATMUL, "float32")
    wdir = tmp / "w9t"
    source = SpaceDataset.load(src)
    WisdomStore(wdir).save(Wisdom("matmul", [_measured_record(source)]))
    kind = current_device_kind()
    rc = transfer_cli(["predict", "--datasets", str(src), "--target", kind,
                       "--wisdom-dir", str(wdir)])
    wisdom = WisdomStore(wdir).load("matmul")
    _, tier = wisdom.select(kind, QS_MATMUL, "float32",
                            builder.default_config())
    eligible = transfer_scenario(source, kind).eligible()
    check((rc == 0) == eligible and
          (tier == "transfer") == eligible,
          f"transfer predict rc {rc}, tier {tier}, eligible {eligible}")
    # the write path with the gate lowered to 0: a transferred record is
    # checked on the card, merged, and served only below the default gate
    rc0 = transfer_cli(["predict", "--datasets", str(src), "--target", kind,
                        "--wisdom-dir", str(wdir), "--min-confidence", "0"])
    wisdom = WisdomStore(wdir).load("matmul")
    moved = [r for r in wisdom.records if r.is_transferred()]
    _, tier_default = wisdom.select(kind, QS_MATMUL, "float32",
                                    builder.default_config())
    _, tier_zero = wisdom.select(kind, QS_MATMUL, "float32",
                                 builder.default_config(),
                                 min_transfer_confidence=0.0)
    check(rc0 == 0 and len(moved) == 1 and moved[0].oracle_verified()
          and tier_zero == "transfer"
          and (tier_default == "transfer") == eligible,
          f"transfer predict --min-confidence 0: rc {rc0}, {len(moved)} "
          f"transferred, tiers {tier_default}/{tier_zero}")
    res["transfer_predict"] = {
        "rc": rc, "eligible": eligible, "tier": tier,
        "forced_record_confidence": moved[0].transfer_confidence(),
        "tier_after_forced": tier_default, "tier_gate_0": tier_zero}
    print("write paths " + json.dumps(res), flush=True)
    return res


def phase_recorded(tmp: Path) -> dict:
    """Phase 9: recorded spaces on the card and transfer onto it."""
    t9 = time.perf_counter()
    runs0 = _build.NVCC_RUNS
    store = DatasetStore(tmp / "datasets")
    mm = record_on_card("matmul", QS_MATMUL, "float32")
    fa = record_on_card("flash_attention_causal", lm_flash_shape(),
                        "bfloat16")
    builds = _build.NVCC_RUNS - runs0
    print(f"phase 9 nvcc runs while recording: {builds}", flush=True)
    check(builds == 0, f"phase 9 built {builds} libraries: phase 1 must "
          f"build every config the recordings launch")
    out = {"builds": builds}
    for ds in (mm, fa):
        store.save(ds)
        out[ds.kernel] = {"replay": replay(ds),
                          "transfer": transfer_onto_card(ds, store)}
    out["write_paths"] = write_paths(tmp, store)
    out["seconds"] = time.perf_counter() - t9
    print(f"phase 9 (recorded spaces and transfer) took "
          f"{out['seconds']:.1f}s", flush=True)
    return out


# ------------------------------------------------ fleet wisdom (10)

#: Misses each phase-10 scenario is seeded with (the coordinator plans a
#: job from 3).
FLEET_MISSES = 5
#: Seconds a phase-10 subprocess may run (it imports torch first).
FLEET_PROC_TIMEOUT_S = 300


def fleet_demand() -> list:
    """Phase 10 item 1's demand: the quickstart's matmul and the LM
    slice's causal flash attention, on the card's kind."""
    kind = current_device_kind()
    return [("matmul", (kind, QS_MATMUL, "float32"), FLEET_MISSES),
            ("flash_attention_causal", (kind, lm_flash_shape(), "bfloat16"),
             FLEET_MISSES)]


def launch_counts() -> dict:
    """Every CUDA kernel's launches so far (phase 10 reads differences)."""
    return {k: _build.CUDA_KERNELS[k].launches for k in TPU_KERNELS}


def launches_since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def gate_verdict(name: str, rec: dict):
    """The verdict the gate on the card gave a record's config (the
    process-wide cache every OracleGate shares)."""
    b = get_kernel(name)
    return gate_module._VERDICT_CACHE.get(
        (name, tuple(rec["problem_size"]), rec["dtype"],
         b.space.freeze(rec["config"]), "cuda"))


def fleet_library(tmp: Path) -> dict:
    """Phase 10 item 1: ``run_local_fleet`` under the cost model over a
    directory each, 1 worker and then 3 with w1 crashing after 13
    evaluations: the same wisdom bytes, every lease claimed once but the
    crashed shard's, and each winner through the coordinator's gate on
    the card (its K3 and K4 launches counted here)."""
    clear_verdict_cache()
    before = launch_counts()
    runs = {}
    for n, crash in ((1, None), (3, "w1")):
        runs[n] = run_local_fleet(
            n_workers=n, demand=fleet_demand(),
            transport=DirectoryTransport(tmp / f"fleet-{n}w"),
            crash_worker=crash, crash_after_evals=13 if crash else None,
            device="cuda")
    gate = launches_since(before)
    one, three = runs[1], runs[3]
    names = sorted(three.wisdom_docs)
    check(names == ["flash_attention_causal", "matmul"]
          and all((tmp / "fleet-1w" / f"{n}.wisdom.json").read_bytes()
                  == (tmp / "fleet-3w" / f"{n}.wisdom.json").read_bytes()
                  for n in names),
          "fleet: 1 worker and 3 with a crash assembled different wisdom")
    claims = sorted(three.claims().values())
    check(three.crashes == 1 and claims == [1] * (len(claims) - 1) + [2]
          and set(one.claims().values()) == {1}
          and three.status["jobs_open"] == 0
          and len(three.jobs_assembled) == 2,
          f"fleet: crashes {three.crashes}, claims {three.claims()}, "
          f"status {three.status}")
    check(gate.get("matmul", 0) > 0 and gate.get("flash_attention", 0) > 0,
          f"fleet: the gate launched {gate} on the card")
    out = {"gate_launches": gate, "claims_3w": claims,
           "shards_by_worker": three.shards_by_worker,
           "evals_by_worker": three.evals_by_worker, "winners": {}}
    for name in names:
        rec, = three.wisdom_docs[name]["records"]
        v = gate_verdict(name, rec)
        check(v is not None and v.ok and rec["provenance"].get("verified"),
              f"fleet: {name} winner {rec['config']} gate {v}")
        ds = RECORDINGS[name]
        entry = ds.lookup(rec["config"])
        out["winners"][name] = {
            "config": rec["config"], "model_us": rec["score_us"],
            "gate": v.status, "gate_max_abs_err": v.max_err,
            "recorded_us": entry.score_us if entry else None,
            "recording_best_us": ds.best().score_us,
            "fraction_of_recorded_best": fraction_of_optimum(ds,
                                                             rec["config"])}
    print("fleet (1) " + json.dumps(out), flush=True)
    return out


def fleet_timed() -> dict:
    """Phase 10 item 2: a coordinator gating on the card and 3 workers
    under a ManualClock, round robin in this process, each shard's
    evaluations timed on the card (WallClockEvaluator: the first launch
    checks and is unscored, the best of 5 after L2 flushes): the
    quickstart's matmul in 4 shards over its 216 configs."""
    kind = current_device_kind()
    bus = ControlBus(MemoryTransport())
    seed_demand(bus, "phase10", [("matmul", (kind, QS_MATMUL, "float32"),
                                  FLEET_MISSES)])
    coord = Coordinator(bus, n_shards=4, max_evals_per_shard=216,
                        device="cuda")
    job, = coord.plan()
    args = matrices(*QS_MATMUL, "float32", seed=10)
    clock = ManualClock()
    workers = [FleetWorker(bus, f"w{i}", clock=clock,
                           evaluator_factory=lambda builder, _job:
                           WallClockEvaluator(builder, args, device="cuda"))
               for i in range(3)]
    t = time.perf_counter()
    progressed = True
    while progressed:
        progressed = False
        for w in workers:
            progressed |= w.run_once() is not None
    tune_s = time.perf_counter() - t
    report = coord.tick()
    check(report.assembled == [job.job_id],
          f"timed fleet: assembled {report.assembled}")
    rec, = transport_wisdom(bus.transport, "matmul").records
    evals = sum(w.evals_run for w in workers)
    ds = RECORDINGS["matmul"]
    check(evals == get_kernel("matmul").space.valid_cardinality()
          and rec.oracle_verified() is not None,
          f"timed fleet: {evals} evaluations, provenance {rec.provenance}")
    out = {"config": rec.config, "score_us": rec.score_us,
           "objective": rec.provenance["objective"], "evaluations": evals,
           "tune_s": tune_s, "phase9_best": ds.best().config,
           "phase9_best_us": ds.best().score_us,
           "phase9_us_of_this_config": ds.lookup(rec.config).score_us,
           "shards_by_worker": {w.worker_id: w.shards_done
                                for w in workers}}
    del args
    print("fleet (2) timed " + json.dumps(out), flush=True)
    return out


def fleet_run(*argv: str) -> subprocess.CompletedProcess:
    """``python -m repro_torch.fleet ...`` (or another module) in a child
    process; every phase-10 child must exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *argv], env=env,
                          capture_output=True, text=True,
                          timeout=FLEET_PROC_TIMEOUT_S)


def check_proc(p: subprocess.CompletedProcess, what: str) -> str:
    check(p.returncode == 0, f"{what}: rc {p.returncode}\n{p.stdout}\n"
          f"{p.stderr[-3000:]}")
    return p.stdout


def fleet_processes(tmp: Path) -> dict:
    """Phase 10 item 3: phase 8's demand on a shared directory; ``plan``,
    two concurrent ``work --poll`` processes, ``coordinate --rounds 3``
    (in this process, so the gate's launches on the card are counted),
    ``status``; then each assembled config through a WisdomKernel on a
    store pulled from the directory, at 512^3 on the card."""
    d = tmp / "fleet-cli"
    bus = ControlBus(DirectoryTransport(d))
    publish_demand(bus, "phase8", DEMAND)
    secs, t = {}, time.perf_counter()
    print("fleet (3) plan: " + check_proc(
        fleet_run("repro_torch.fleet", "plan", "--dir", str(d)), "plan")
        .strip().replace("\n", " | "), flush=True)
    secs["plan"], t = time.perf_counter() - t, time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        works = list(pool.map(lambda w: fleet_run(
            "repro_torch.fleet", "work", "--dir", str(d), "--worker-id", w,
            "--poll", "0.5"), ("host-a", "host-b")))
    secs["work"] = time.perf_counter() - t
    for w, p in zip(("host-a", "host-b"), works):
        print(f"fleet (3) {w}: " + check_proc(p, f"work {w}").strip()
              .replace("\n", " | "), flush=True)
    before, t = launch_counts(), time.perf_counter()
    rc = fleet_cli(["coordinate", "--dir", str(d), "--rounds", "3"])
    secs["coordinate"], t = time.perf_counter() - t, time.perf_counter()
    gate = launches_since(before)
    check(rc == 0 and gate.get("advec_u", 0) > 0
          and gate.get("diff_uvw_fused", 0) > 0,
          f"fleet coordinate: rc {rc}, gate launches {gate}")
    status = check_proc(fleet_run("repro_torch.fleet", "status", "--dir",
                                  str(d)), "status")
    secs["status"] = time.perf_counter() - t
    print("fleet (3) status: " + status.strip().replace("\n", " | "),
          flush=True)
    done = bus.docs("done")
    check(len(done) == len(bus.names("job")) == len(DEMAND)
          and all(doc["state"] == "assembled" for doc in done),
          f"fleet (3): done documents {done}")
    store = WisdomStore(tmp / "fleet-cli-pulled")
    PullSync(store, DirectoryTransport(d)).pull()
    cuda = torch.device("cuda")
    out = {"gate_launches": gate, "jobs": len(done), "selected": {},
           "seconds": secs}
    for name in sorted(DEMAND):
        rec, = store.load(name).records
        k = WisdomKernel(get_kernel(name), wisdom_dir=store.root,
                         device_kind=current_device_kind())
        args = tune_microhh.launch_args(name, ONLINE_GRID, "float32", cuda)
        got = k(*args)
        st = k.stats[-1]
        want = (ref.advec_u_ref(*args) if name == "advec_u"
                else ref.diff_uvw_ref(*args))
        v = verify_outcome(got, want, "float32")
        check(st.tier == "exact" and st.config == rec.config and v.ok,
              f"fleet (3) {name}: tier {st.tier}, {st.config} vs "
              f"{rec.config}, {v.error}")
        out["selected"][name] = {"config": rec.config,
                                 "model_us": rec.score_us, "tier": st.tier,
                                 "max_abs_err": v.max_err}
        del args, got, want
    torch.cuda.empty_cache()
    print("fleet (3) " + json.dumps(out), flush=True)
    return out


def lm_serve(model, params, sync=None):
    """Phase 5e's 8 requests through a fresh ServeEngine; (report, s)."""
    eng = ServeEngine(model, params, n_slots=4, max_seq=256, mode="token",
                      sync=sync)
    rng = np.random.default_rng(0)
    for rid in range(8):
        prompt = rng.integers(0, model.cfg.vocab, int(rng.integers(8, 33)),
                              dtype=np.int32)
        check(eng.submit(Request(rid, prompt, max_new_tokens=16)),
              f"request {rid} rejected")
    rep, sec = timed(eng.run)
    check(rep.requests_completed == 8
          and all(len(t) == 16 for t in rep.values()),
          f"serve: {rep.to_json()}")
    return rep, sec


def fleet_serve_pull(tmp: Path, fleet_dir: Path, lm_wisdom: Path) -> dict:
    """Phase 10 item 4: a serving host whose store is a copy of phase
    5d's wisdom pulls item 1's fleet directory from its decode loop
    (``ServeEngine(sync=PullSync(...))``, ops' flash WisdomKernel
    attached); the next 4 x 2048 prefill selects the merged record."""
    local = tmp / "fleet-serve-wisdom"
    shutil.copytree(lm_wisdom, local)
    store = WisdomStore(local)
    kind = current_device_kind()
    fa = ops.fa_causal_kernel
    cfg = get_arch(LM_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tok = lm_tokens(LM_BATCH, LM_SEQ, cfg.vocab, seed=2)
    scen = (kind, lm_flash_shape(), "bfloat16")
    local_rec, = [r for r in store.load(fa.builder.name).records
                  if r.scenario() == scen]
    with quickstart._env(**{WISDOM_DIR_ENV: str(local)}):
        ops.reload_wisdom()
        before, _ = model.prefill(params, tok,
                                  model.init_cache(LM_BATCH, LM_SEQ))
        check(fa.stats[-1].tier == "exact"
              and fa.stats[-1].config == local_rec.config,
              f"serve pull: the prefill before the pull ran "
              f"{fa.stats[-1].tier} {fa.stats[-1].config}")
        # without sync, with it, and without it again, obs on throughout
        obs_runtime.disable()
        reg, _ = obs_runtime.enable()
        plain, plain_s = lm_serve(model, params)
        sync = PullSync(store, DirectoryTransport(fleet_dir), kernels=[fa])
        synced, synced_s = lm_serve(model, params, sync)
        _, again_s = lm_serve(model, params)
        ticks = {k: v for k, v in reg.snapshot()["counters"].items()
                 if k.startswith("serve.sync_tick")}
        obs_runtime.disable()
        check(synced.sync_pulls >= 1 and synced.sync_failures == 0
              and sync.failures == 0
              and ticks.get("serve.sync_tick{outcome=pulled}", 0) >= 1,
              f"serve pull: {synced.to_json()}, {ticks}")
        merged, = [r for r in store.load(fa.builder.name).records
                   if r.scenario() == scen]
        after, _ = model.prefill(params, tok,
                                 model.init_cache(LM_BATCH, LM_SEQ))
        st = fa.stats[-1]
    ops.reload_wisdom()
    err = logit_errors(after, before)
    check(st.tier == "exact" and st.config == merged.config
          and lm_bf16_ok(err),
          f"serve pull: the prefill after the pull ran {st.tier} "
          f"{st.config} (merged {merged.config}), logits {err}")
    out = {"local": {"config": local_rec.config,
                     "score_us": local_rec.score_us,
                     "objective": local_rec.provenance.get("objective")},
           "merged": {"config": merged.config, "score_us": merged.score_us,
                      "source": merged.provenance.get("source", "local"),
                      "objective": merged.provenance.get("objective")},
           "sync_pulls": synced.sync_pulls,
           "sync_failures": synced.sync_failures, "sync_ticks": ticks,
           "prefill_tier": st.tier, "logits_vs_before_pull": err,
           "tok_s_without_sync": [8 * 16 / plain_s, 8 * 16 / again_s],
           "tok_s_with_sync": 8 * 16 / synced_s,
           "steps": [plain.steps, synced.steps]}
    del model, params, before, after
    torch.cuda.empty_cache()
    print("fleet (4) " + json.dumps(out), flush=True)
    return out


def fleet_broadcast(tmp: Path, microhh_wisdom: Path) -> dict:
    """Phase 10 item 5: phase 8 item 2's K2b promotion with a
    ``PushSync`` broadcast hook; a second host pulls the record and serves
    it at tier exact, its 512^3 output against the plain version."""
    copy = tmp / "fleet-k2b"
    shutil.copytree(microhh_wisdom, copy)
    transport = DirectoryTransport(tmp / "fleet-broadcast")
    clear_verdict_cache()
    res = deterministic_promotion(
        copy, broadcast=PushSync(WisdomStore(copy), transport),
        label="fleet (5)")
    remote = [r for r in transport_wisdom(transport, "diff_uvw").records
              if r.config == K2B_TILE]
    check(res["broadcasts"] == 1 and len(remote) == 1,
          f"broadcast: {res['broadcasts']} broadcasts, {len(remote)} "
          f"records on the transport")
    second = WisdomStore(tmp / "fleet-second")
    PullSync(second, transport).pull()
    k = WisdomKernel(get_kernel("diff_uvw"), wisdom_dir=second.root,
                     device_kind=current_device_kind())
    args = tune_microhh.launch_args("diff_uvw", ONLINE_GRID, "float32",
                                    torch.device("cuda"))
    got = k(*args)
    st = k.stats[-1]
    v = verify_outcome(got, ref.diff_uvw_ref(*args), "float32")
    check(st.tier == "exact" and st.config == K2B_TILE and v.ok,
          f"broadcast: the second host ran {st.tier} {st.config}: "
          f"{v.error}")
    out = {"broadcasts": res["broadcasts"], "second_host_tier": st.tier,
           "max_abs_err": v.max_err}
    del args, got
    torch.cuda.empty_cache()
    print("fleet (5) " + json.dumps(out), flush=True)
    return out


def fleet_operator_cli(tmp: Path) -> dict:
    """Phase 10 item 6: ``python -m repro_torch.wisdom`` inspect, validate
    and diff over the phase's stores, three children at once."""
    runs = {
        "inspect": ("inspect", "--dir", str(tmp / "fleet-serve-wisdom"),
                    "-v"),
        "validate": ("validate", "--dir", str(tmp / "fleet-3w")),
        "diff": ("diff", str(tmp / "fleet-second"),
                 str(tmp / "fleet-broadcast")),
    }
    with ThreadPoolExecutor(max_workers=len(runs)) as pool:
        procs = dict(zip(runs, pool.map(
            lambda argv: fleet_run("repro_torch.wisdom", *argv),
            runs.values())))
    out = {}
    for cmd, p in procs.items():
        text = check_proc(p, f"wisdom {cmd}")
        print(f"fleet (6) wisdom {cmd}: " + text.strip().replace(
            "\n", " | "), flush=True)
        out[cmd] = p.returncode
    check(procs["validate"].stdout.rstrip().endswith(", 0 issue(s)")
          and "identical" in procs["diff"].stdout,
          "wisdom validate found issues, or diff found a difference")
    return out


def phase_fleet(tmp: Path, microhh_wisdom: Path, lm_wisdom: Path) -> dict:
    """Phase 10: fleet wisdom distribution on the card, each item's nvcc
    runs and seconds printed."""
    t10 = time.perf_counter()
    before = launch_counts()
    items = (
        ("1 library fleet", lambda: fleet_library(tmp)),
        ("2 timed fleet", fleet_timed),
        ("3 CLI fleet", lambda: fleet_processes(tmp)),
        ("4 serving pull", lambda: fleet_serve_pull(tmp, tmp / "fleet-3w",
                                                    lm_wisdom)),
        ("5 broadcast", lambda: fleet_broadcast(tmp, microhh_wisdom)),
        ("6 operator CLI", lambda: fleet_operator_cli(tmp)),
    )
    out = {}
    for label, fn in items:
        runs0, t = _build.NVCC_RUNS, time.perf_counter()
        out[label] = fn()
        print(f"phase 10 item {label}: {_build.NVCC_RUNS - runs0} nvcc "
              f"runs, {time.perf_counter() - t:.1f}s", flush=True)
    out["seconds"] = time.perf_counter() - t10
    out["launches"] = launches_since(before)
    print(f"phase 10 launches: {json.dumps(out['launches'])}", flush=True)
    print(f"phase 10 (fleet wisdom) took {out['seconds']:.1f}s", flush=True)
    return out


# ------------------------------------------------------------ training slice

#: Phase 11 (a): codeqwen1.5-7b at full width cut to 2 layers (32 would
#: need ~98 GB of parameters, gradients and f32 moments), bf16, 4 x 2048
#: tokens a step in 2 microbatches, so each microbatch runs K4 at BH 64 x
#: S 2048 x D 128; 8 steps, the online tick on the first 4.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 2, 4, 2048, 2
TRAIN_STEPS, TRAIN_WARMUP = 8, 4
#: K4 launches a step: each layer's forward and its remat recompute, in
#: each microbatch; the backward kernel's: each layer's backward in each
#: microbatch.
TRAIN_K4_PER_STEP = 2 * TRAIN_LAYERS * TRAIN_MICRO
TRAIN_BWD_PER_STEP = TRAIN_LAYERS * TRAIN_MICRO
#: (b) float32 output and gradients (K4's mma body) against the plain
#: version's autograd: rtol = 1e-3, atol = 1e-3 x max|ref|, as phase 5a
#: holds f32 prefill logits; bf16 takes the LM slice's LM_BF16_TOL. Both
#: backwards are the plain version's, so the gradients differ only by
#: summation order (the flattened heads).
TRAIN_F32_TOL = 1e-3
#: (c): a config that still reaches K4 (d_head 128, seq 128), float32.
TRAIN_SMALL = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2,
                   d_head=128, d_ff=512, vocab=512)
#: chip_smoke.py runs itself with this flag as (c)'s crash-and-resume child.
TRAIN_RESUME_FLAG = "--train-resume-child"
#: Seconds a phase-11 child may run (it imports torch first).
TRAIN_PROC_TIMEOUT_S = 300


class TimedCheckpoints(CheckpointManager):
    """The driver's checkpoint manager, with each save's seconds."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.save_s: list[float] = []

    def save(self, step, state, extra_meta=None):
        t0 = time.perf_counter()
        path = super().save(step, state, extra_meta)
        self.save_s.append(time.perf_counter() - t0)
        return path


def train_full_width(tmp: Path) -> tuple:
    """Phase 11 (a): ``TrainDriver`` over ``make_train_step`` at full
    width; returns its readings, the model, the final state and the
    dataset ((b) reads the last three)."""
    fa = _build.CUDA_KERNELS["flash_attention"]
    bwd = _build.CUDA_KERNELS["flash_attention_bwd"]
    kern = ops.fa_causal_kernel
    cfg = replace(get_arch(LM_ARCH), n_layers=TRAIN_LAYERS)
    n_params = n_elements(build_model(cfg, device="meta").init())
    need = n_params * (2 + 4 + 4)       # bf16 parameters, f32 m and v
    disk = shutil.disk_usage(tmp)
    print(f"train (a) a checkpoint of {n_params / 1e9:.3f} B parameters "
          f"takes ~{need / 1e9:.2f} GB; {tmp} has {disk.free / 1e9:.1f} GB "
          f"free of {disk.total / 1e9:.1f}", flush=True)
    check(disk.free > 1.1 * need, f"the machine cannot hold one checkpoint:"
          f" {disk.free / 1e9:.1f} GB free, {need / 1e9:.2f} GB needed")
    model = build_model(cfg, device="cuda", remat=True)
    opt = AdamW(lr=cosine_schedule(3e-4, warmup=2, total=TRAIN_STEPS))
    ds = SyntheticTokenDataset(vocab=cfg.vocab, seq=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, seed=17)
    wisdom = tmp / "train-wisdom"
    ckpt = TimedCheckpoints(tmp / "train-ckpt", keep=1,
                            save_every=TRAIN_STEPS + 1)
    problem = (TRAIN_BATCH // TRAIN_MICRO * cfg.n_heads,
               TRAIN_BATCH // TRAIN_MICRO * cfg.n_kv_heads, TRAIN_SEQ,
               cfg.d_head)
    out = {"n_params": n_params}
    with quickstart._env(**{WISDOM_DIR_ENV: str(wisdom)}):
        ops.reload_wisdom()
        svc = enable_online_tuning(kern, objective="wallclock", seed=0,
                                   wisdom_dir=wisdom)
        step_fn = make_train_step(model, opt, microbatches=TRAIN_MICRO,
                                  online=svc,
                                  online_warmup_steps=TRAIN_WARMUP)
        driver = TrainDriver(model=model, optimizer=opt, train_step=step_fn,
                             dataset=ds, ckpt=ckpt, total_steps=TRAIN_STEPS,
                             log_every=TRAIN_STEPS)
        n0 = len(kern.stats)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        try:
            run = driver.run(torch.Generator(device="cuda").manual_seed(0))
        finally:
            kern.attach_online(None)
        out["launches"] = {"flash_attention": fa.launches,
                           "flash_attention_bwd": bwd.launches}
        out["by_body"] = dict(flash_attention.BODY_LAUNCHES)
        stats = kern.stats[n0:]
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        state = run["state"]
        # one more step under the profiler (online detached): device busy
        # time, and the host's wait in the per-launch event syncs
        batch = move_batch(ds.batch(TRAIN_STEPS), "cuda")
        out["profile"] = device_profile(lambda: step_fn(state, batch),
                                        f"train step ({LM_ARCH}, "
                                        f"{TRAIN_LAYERS} layers)",
                                        own="fa_wgmma_kernel", host_ops=True)
    ops.reload_wisdom()
    hist = run["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"train (a) losses {losses}")
    want = TRAIN_K4_PER_STEP * TRAIN_STEPS
    tiers = Counter(s.tier for s in stats)
    check(len(stats) == want, f"train (a) launched K4 {len(stats)} times "
          f"through the WisdomKernel, want {want}")
    check(out["launches"]["flash_attention"] >= want,
          f"train (a) counted {out['launches']} K4 launches, want >= {want}")
    want_bwd = TRAIN_BWD_PER_STEP * TRAIN_STEPS
    check(out["launches"]["flash_attention_bwd"] == want_bwd,
          f"train (a) counted {out['launches']['flash_attention_bwd']} "
          f"backward launches, want {want_bwd}")
    steady = [h["s"] for h in hist[TRAIN_WARMUP:]]
    out |= {"losses": losses, "step_s": [h["s"] for h in hist],
            "tok_s_steps_5_8": TRAIN_BATCH * TRAIN_SEQ * len(steady)
            / sum(steady), "k4_calls": len(stats), "tiers": dict(tiers),
            "extra_k4_launches": out["launches"]["flash_attention"] - want}
    out["busy_share"] = (out["profile"]["device_ms_per_step"]
                         / (statistics.median(steady) * 1e3))
    st = svc.state(problem, cfg.compute_dtype)
    ends = [e[0] for e in svc.events if e[0] in (
        "promote", "keep-incumbent", "oracle-reject", "no-candidates")]
    out["online"] = {
        "activated": st is not None,
        "finished": bool(st is not None and st.finished),
        "outcome": ends[-1] if ends else "unfinished",
        "trial_launches": tiers.get("trial", 0),
        "events": dict(Counter(e[0] for e in svc.events))}
    final = Path(run["final_checkpoint"])
    like = init_train_state(build_model(cfg, device="meta"), opt)
    (restored, manifest), load_s = timed(lambda: load_checkpoint(
        ckpt.directory, like=like, device="cuda"))
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
               zip(tree.leaves(state), tree.leaves(restored)))
    check(same and manifest["step"] == TRAIN_STEPS,
          "train (a) the restored checkpoint differs from the saved state")
    out["ckpt"] = {"gb": sum(p.stat().st_size for p in final.iterdir())
                   / 1e9, "save_s": ckpt.save_s[-1], "restore_s": load_s,
                   "leaves": len(manifest["leaves"]), "bit_exact": same}
    del restored, like
    print(f"train (a) {LM_ARCH} full width x {TRAIN_LAYERS} layers, bf16, "
          f"{n_params / 1e9:.3f} B parameters, {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens a step in {TRAIN_MICRO} microbatches, remat: losses "
          f"{[round(x, 4) for x in losses]}; step seconds "
          f"{[round(x, 3) for x in out['step_s']]}; "
          f"{out['tok_s_steps_5_8']:.0f} tokens/s over steps 5-8; peak "
          f"device memory {out['peak_gb']:.1f} GB", flush=True)
    print(f"train (a) device busy {out['profile']['device_ms_per_step']:.1f} "
          f"ms of a {statistics.median(steady) * 1e3:.1f} ms step "
          f"({out['busy_share']:.0%}); the host waited "
          f"{out['profile']['event_sync_ms_per_step']:.1f} ms in event "
          f"syncs", flush=True)
    print(f"train (a) K4: {len(stats)} calls through the WisdomKernel "
          f"({TRAIN_K4_PER_STEP} a step: forward and recompute), tiers "
          f"{json.dumps(dict(tiers))}, {out['launches']['flash_attention']} "
          f"launches ({out['extra_k4_launches']} beyond the calls: the "
          f"promotion gate's), by body {json.dumps(out['by_body'])}; online "
          f"{json.dumps(out['online'])}; the backward kernel "
          f"{out['launches']['flash_attention_bwd']} launches "
          f"({TRAIN_BWD_PER_STEP} a step at BH {problem[0]})", flush=True)
    print(f"train (a) final checkpoint {out['ckpt']['gb']:.2f} GB, "
          f"{out['ckpt']['leaves']} leaves: saved in "
          f"{out['ckpt']['save_s']:.1f} s, restored in "
          f"{out['ckpt']['restore_s']:.1f} s, bit-exact", flush=True)
    return out, model, state, ds


def train_gradients(model, params, ds) -> dict:
    """Phase 11 (b): one layer's attention input at the full-width shape
    through ``ops.attention`` (K4 + ``FlashAttentionFn``) and through
    ``ref.attention_ref``, both under autograd; q/k/v gradients compared,
    in bfloat16 (wgmma body) and float32 (mma body)."""
    fa = _build.CUDA_KERNELS["flash_attention"]
    bwd = _build.CUDA_KERNELS["flash_attention_bwd"]
    cfg = model.cfg
    b = TRAIN_BATCH // TRAIN_MICRO
    tokens = move_batch(ds.batch(0), "cuda")["tokens"][:b]
    with torch.no_grad():
        blk = params["layers"][0]
        h = apply_norm(cfg, blk["ln1"], model._embed(params, tokens))
        qkv = attention._qkv(cfg, blk["attn"], h,
                             torch.arange(TRAIN_SEQ, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for dtype, body in (("bfloat16", "wgmma"), ("float32", "mma")):
        q, k, v = (t.to(DTYPES[dtype]).contiguous() for t in qkv)
        ct = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
        got = [t.clone().requires_grad_(True) for t in (q, k, v)]
        bodies0 = dict(fa.body_launches)
        o = ops.attention(*got, causal=True)
        check(flash_attention.through_flash_fn(o), f"train (b) {dtype}: "
              f"ops.attention's output does not carry FlashAttentionFn")
        ran = {x: n - bodies0.get(x, 0) for x, n in fa.body_launches.items()
               if n != bodies0.get(x, 0)}
        check(ran == {body: 1}, f"train (b) {dtype} ran {ran}, want one "
              f"{body} launch")
        n_bwd = bwd.launches
        o.backward(ct)
        check(bwd.launches - n_bwd == (dtype == "bfloat16"),
              f"train (b) {dtype}: {bwd.launches - n_bwd} backward kernel "
              f"launches")
        want = [t.clone().requires_grad_(True) for t in (q, k, v)]
        w = ref.attention_ref(*want, causal=True)
        w.backward(ct)
        pairs = {"out": (o.detach(), w.detach()),
                 **{"d" + n: (a.grad, r.grad)
                    for n, a, r in zip("qkv", got, want)}}
        errs = {}
        for name, (a, r) in pairs.items():
            errs[name] = e = logit_errors(a, r)
            ok = (lm_bf16_ok(e) if dtype == "bfloat16" else torch.allclose(
                a.double(), r.double(), rtol=TRAIN_F32_TOL,
                atol=TRAIN_F32_TOL * e["max_abs_ref"]))
            check(ok, f"train (b) {dtype} {name}: {e}")
        out[dtype] = errs
        print(f"train (b) {dtype} ({body} body), BH {q.shape[0] * q.shape[1]}"
              f" x S {TRAIN_SEQ} x D {cfg.d_head}, causal: K4 + "
              f"{'its backward kernel' if dtype == 'bfloat16' else 'autograd'}"
              f" vs the plain version's autograd {json.dumps(errs)} ok",
              flush=True)
        del got, want, o, w
    return out


def train_resume_child(tmp: Path) -> int:
    """Phase 11 (c)'s child: under deterministic algorithms, an
    uninterrupted 8-step run of the small config, and a run killed by
    ``InjectedFault`` at step 5 then resumed from its step-4 checkpoint;
    prints one JSON line and exits 0 when the final states are equal bit
    for bit."""
    torch.use_deterministic_algorithms(True)
    cfg = get_arch(LM_ARCH).reduced(**TRAIN_SMALL)
    fa = _build.CUDA_KERNELS["flash_attention"]

    def build(d, fault=None):
        model = build_model(cfg, device="cuda", remat=True)
        opt = AdamW(lr=cosine_schedule(1e-3, warmup=2, total=8))
        ds = SyntheticTokenDataset(vocab=cfg.vocab, seq=128, global_batch=4,
                                   seed=5)
        return TrainDriver(
            model=model, optimizer=opt,
            train_step=make_train_step(model, opt, microbatches=2),
            dataset=ds, ckpt=CheckpointManager(d, keep=2, save_every=4),
            total_steps=8, fault_injector=fault, log_every=100)

    def bomb(step):
        if step == 5:
            raise InjectedFault("simulated node failure at step 5")

    t0 = time.perf_counter()
    whole = build(tmp / "whole").run(7)
    n_whole = fa.launches
    try:
        build(tmp / "crash", fault=bomb).run(7)
        crashed = False
    except InjectedFault:
        crashed = True
    resumed_from = latest_step(tmp / "crash")
    n_crash = fa.launches - n_whole
    resumed = build(tmp / "crash").run(7)
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
        tree.leaves(whole["state"]), tree.leaves(resumed["state"])))
    res = {"crashed": crashed, "resumed_from": resumed_from,
           "bit_exact": same, "k4_launches": {
               "whole": n_whole, "crashed": n_crash,
               "resumed": fa.launches - n_whole - n_crash},
           "losses": [h["loss"] for h in whole["history"]],
           "resumed_steps": [h["step"] for h in resumed["history"]],
           "seconds": time.perf_counter() - t0}
    print("resume " + json.dumps(res), flush=True)
    return 0 if (crashed and resumed_from == 4 and same
                 and res["resumed_steps"] == [4, 5, 6, 7]) else 1


def train_children(tmp: Path) -> list:
    """Phase 11 (c)'s two children, started together: the crash and
    resume check (this script with TRAIN_RESUME_FLAG) and the entry point
    ``python -m repro_torch.examples.train_lm --steps 30``. cuBLAS reads
    CUBLAS_WORKSPACE_CONFIG when it makes its handles, so it is set in the
    children's environment, before any."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8",
               **{WISDOM_DIR_ENV: str(tmp / "child-wisdom")})
    argvs = {"resume": [str(ROOT / "chip_smoke.py"), TRAIN_RESUME_FLAG,
                        str(tmp / "resume")],
             "train_lm": ["-m", "repro_torch.examples.train_lm", "--steps",
                          "30", "--ckpt-dir", str(tmp / "train_lm")]}
    return [(name, time.perf_counter(), subprocess.Popen(
        [sys.executable, *argv], env=env, cwd=tmp, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for name, argv in argvs.items()]


def train_children_results(children: list) -> dict:
    out = {}
    for name, t0, proc in children:
        try:
            text, _ = proc.communicate(timeout=TRAIN_PROC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            raise RuntimeError(f"train (c) {name} child ran over "
                               f"{TRAIN_PROC_TIMEOUT_S} s:\n{text[-3000:]}")
        check(proc.returncode == 0, f"train (c) {name} child: rc "
              f"{proc.returncode}\n{text[-4000:]}")
        out[name] = {"seconds": time.perf_counter() - t0, "text": text}
    line = [x for x in out["resume"]["text"].splitlines()
            if x.startswith("resume ")][-1]
    res = json.loads(line.removeprefix("resume "))
    print(f"train (c) crash at step 5 and resume from step "
          f"{res['resumed_from']} ({LM_ARCH} reduced to d_model "
          f"{TRAIN_SMALL['d_model']}, d_head {TRAIN_SMALL['d_head']}, seq "
          f"128, float32, deterministic algorithms): final state bit-exact "
          f"{res['bit_exact']}; K4 launches {json.dumps(res['k4_launches'])}"
          f"; child {out['resume']['seconds']:.1f} s", flush=True)
    m = re.search(r"mean of the first 5 ([0-9.]+), of the last 5 ([0-9.]+)",
                  out["train_lm"]["text"])
    check(m is not None, f"train (c) train_lm printed no loss means:\n"
          f"{out['train_lm']['text'][-3000:]}")
    first, last = float(m.group(1)), float(m.group(2))
    check(last < first, f"train (c) train_lm did not lower its loss: mean "
          f"of the first 5 {first}, of the last 5 {last}")
    head = out["train_lm"]["text"].splitlines()[0]
    print(f"train (c) python -m repro_torch.examples.train_lm --steps 30 "
          f"({head}): mean loss of the first 5 steps {first:.4f}, of the "
          f"last 5 {last:.4f}; child {out['train_lm']['seconds']:.1f} s",
          flush=True)
    return {"resume": res, "train_lm": {"first5": first, "last5": last,
                                        "seconds":
                                        out["train_lm"]["seconds"]}}


def phase_train(tmp: Path) -> dict:
    """Phase 11: the training slice. (a) full-width training, its launch
    counts read just after the driver's run; then (c)'s children start,
    and (b) runs beside them on the trained parameters."""
    t0 = time.perf_counter()
    out, model, state, ds = train_full_width(tmp)
    children = train_children(tmp)
    try:
        out["grad"] = train_gradients(model, state["params"], ds)
        del model, state
        torch.cuda.empty_cache()
        out["children"] = train_children_results(children)
    finally:
        for _, _, proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 11 (training) took {out['seconds']:.1f}s", flush=True)
    return out


# ------------------------------------------------------------ the zoo (12)

ZOO_MOE = "deepseek-moe-16b"
ZOO_VISION = "llama-3.2-vision-11b"
ZOO_MLA = "deepseek-v2-236b"
ZOO_BATCH, ZOO_SEQ, ZOO_DECODE = 4, 2048, 32
#: deepseek-v2-236b at full width, cut in depth to its dense MLA layer 0
#: and 2 MoE+MLA layers: 60 layers would need 472 GB in bfloat16.
ZOO_MLA_LAYERS, ZOO_MLA_BATCH, ZOO_MLA_DECODE = 3, 2, 16
#: (d) deepseek-v2-lite at full width, cut in depth to its dense layer 0
#: and one dropless MoE layer (64 experts of 1408, top-6, 2 shared), MLA
#: in both; its MoE layer's output on its own input is held against the
#: experts in float32 on exactly their routed tokens: at most
#: ZOO_DROPLESS_ROWS_OFF of its rows may have a relative L2 gap above
#: ZOO_DROPLESS_ROW_GAP (the benchmark cell's moe_rows_off and its limit;
#: a dropped pair moves its row by far more), and the whole output's gap
#: may not pass ZOO_DROPLESS_REL_L2 (bf16 products, a few 1e-3).
ZOO_DROPLESS = "deepseek-v2-lite"
ZOO_DROPLESS_LAYERS = 2
ZOO_DROPLESS_ROW_GAP, ZOO_DROPLESS_ROWS_OFF = 0.05, 0.01
ZOO_DROPLESS_REL_L2 = 1e-2
#: The most memory phase 12 may find allocated: phase 11's train state
#: (12.2 GB) must be freed by reference counts alone.
ZOO_START_MAX_GB = 4.0
#: The consistency checks: prefill of this many tokens, then 2 decode
#: steps, against forward over the S + 2 tokens.
ZOO_CHECK_SEQ = 512
#: (a) 1 in float32: deepseek-moe at full width, cut to its dense layer
#: and 3 MoE layers (full depth in f32 would need 65.5 GB of weights).
ZOO_F32_LAYERS = 4
#: Every cross block's gate, opened: the reference initialises it to 0,
#: and tanh(0) = 0 would take the cross blocks out of the output.
ZOO_GATE = 1.0
#: The most (token, k) expert choices that may differ between two bf16
#: paths of one MoE model with their routers free: bf16 flips near ties
#: (4.9-5.7 % for deepseek-moe-16b, 0.5 % for deepseek-v2 on the card),
#: while a router that diverges between the paths differs far more.
ZOO_FLIP_LIMIT = 0.15


def zoo_model(cfg, seed: int):
    """``build_model(cfg)`` on the card with seeded random weights."""
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, sec = timed(lambda: model.init(
        torch.Generator(device="cuda").manual_seed(seed)))
    n = n_elements(params)
    print(f"zoo {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n / 1e9:.3f} B parameters in {cfg.param_dtype} "
          f"(ArchConfig.n_params {cfg.n_params() / 1e9:.3f} B), initialised "
          f"on the card in {sec:.1f} s", flush=True)
    return model, params, n


def k4_snapshot() -> tuple:
    fa = _build.CUDA_KERNELS["flash_attention"]
    return fa.launches, Counter(fa.body_dtype_launches)


def k4_since(snap: tuple) -> tuple[int, Counter]:
    """K4's launches since ``snap``, in all and by (body, dtype)."""
    n, by = k4_snapshot()
    return n - snap[0], by - snap[1]


def zoo_prefills(model, params, tok, img, n_flash: int) -> tuple:
    """A warm-up and two timed prefills of ``tok``; each must launch K4
    ``n_flash`` times, all in the wgmma body. Returns (logits, cache, the
    three runs' seconds)."""
    cfg = model.cfg
    secs = []
    for _ in range(3):
        cache = model.init_cache(tok.shape[0], tok.shape[1] + ZOO_DECODE)
        snap = k4_snapshot()
        (logits, cache), sec = timed(lambda: model.prefill(params, tok, cache,
                                                           img=img))
        n, by = k4_since(snap)
        check(n == n_flash and by[("wgmma", "bfloat16")] == n_flash,
              f"zoo {cfg.name} prefill launched K4 {n} times ({dict(by)}), "
              f"want {n_flash}, all wgmma bfloat16")
        secs.append(sec)
    check(logits.shape == (tok.shape[0], 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          f"zoo {cfg.name} prefill logits not finite or of the wrong shape")
    return logits, cache, secs


def zoo_decode(model, params, cache, logits, steps: int) -> float:
    """``steps`` greedy decode steps after a prefill; ms a step."""
    cfg = model.cfg
    start = int(cache["pos"])
    state = {"cache": cache, "nxt": logits[:, -1].argmax(-1, keepdim=True)}

    def run():
        for _ in range(steps):
            lg, state["cache"] = model.decode_step(params, state["cache"],
                                                   state["nxt"])
            state["nxt"] = lg[:, -1].argmax(-1, keepdim=True)
        return lg

    lg, sec = timed(run)
    check(state["cache"]["pos"] == start + steps
          and bool(torch.isfinite(lg[..., :cfg.vocab]).all()),
          f"zoo {cfg.name} decode logits not finite, or the cursor is wrong")
    return sec / steps * 1e3


def no_drop(cfg):
    """``cfg`` with a capacity factor at which no MoE bucket overflows
    (n_routed / top_k: a bucket holds a whole chunk)."""
    if cfg.moe is None:
        return cfg
    return replace(cfg, moe=replace(
        cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))


@contextlib.contextmanager
def recording_routes(out: list):
    """Each MoE chunk's top-k expert ids, as ``moe.route`` returns them
    to ``moe._moe_chunk``, appended to ``out``."""
    orig = moe_module.route

    def route(cfg, p, xc):
        r = orig(cfg, p, xc)
        out.append(r[3])
        return r

    moe_module.route = route
    try:
        yield
    finally:
        moe_module.route = orig


def routes_by_layer(routes: list, n_moe: int, steps: int = 0) -> list:
    """A run's recorded expert ids as one (B, T, K) tensor a MoE layer: a
    prefill or forward calls the router layer by layer, chunk by chunk,
    then each of ``steps`` decode steps once a layer."""
    n_pre = len(routes) - n_moe * steps
    per = n_pre // n_moe
    check(per * n_moe == n_pre and per > 0,
          f"{len(routes)} router calls do not split into {n_moe} layers")
    return [torch.cat(routes[l * per:(l + 1) * per]
                      + [routes[n_pre + i * n_moe + l] for i in range(steps)],
                      dim=1) for l in range(n_moe)]


@contextlib.contextmanager
def replaying_routes(by_layer: list):
    """``moe.route`` with a recorded run's expert ids (``by_layer``, as
    :func:`routes_by_layer` gives them) in place of its own top-k; the
    gates are the selected experts' own router probabilities,
    renormalised as ``route`` does. Yields ``window(stop)``: call it
    before each entry-point call, whose MoE layers then consume their ids
    up to token ``stop``."""
    orig = moe_module.route
    st = {"layer": 0, "cursor": [0] * len(by_layer), "stop": 0}

    def route(cfg, p, xc):
        logits, probs, _, _ = orig(cfg, p, xc)
        layer, c0 = st["layer"], st["cursor"][st["layer"]]
        sel = by_layer[layer][:, c0:c0 + xc.shape[1]]
        gate = probs.gather(-1, sel)
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
        st["cursor"][layer] = c0 + xc.shape[1]
        if st["cursor"][layer] >= st["stop"]:
            st["layer"] = (layer + 1) % len(by_layer)
        return logits, probs, gate, sel

    def window(stop: int) -> None:
        st["stop"] = stop

    moe_module.route = route
    try:
        yield window
    finally:
        moe_module.route = orig


@contextlib.contextmanager
def plain_attention():
    """``ops.attention`` through the plain ``ref.attention_ref`` on the
    card, K4's plain version: no flash launch inside the block."""
    orig = ops.attention
    ops.attention = lambda q, k, v, **kw: ref.attention_ref(q, k, v, **kw)
    try:
        yield
    finally:
        ops.attention = orig


def routing_share(a: list, b: list, n_experts: int) -> float:
    """The share of (token, k) expert choices of run ``a`` that run ``b``
    did not make for the same token."""
    diff = total = 0
    for x, y in zip(a, b, strict=True):
        ox = F.one_hot(x, n_experts).sum(-2)
        oy = F.one_hot(y, n_experts).sum(-2)
        total += x.numel()
        diff += x.numel() - int((ox * oy).sum())
    return diff / total


def prefill_vs_forward(model, params, tok, img, replay: bool) -> dict:
    """Logit errors of a prefill of all but the last 2 of ``tok`` (K4
    where the stack is flashable) and 2 decode steps, against ``forward``
    over all of ``tok`` (plain attention where its length is no multiple
    of 128). For MoE, with ``replay`` the prefill and decode take
    ``forward``'s expert choices: bf16 rounds the two paths' router
    logits apart, and a top-k choice that flips across a near tie moves a
    token's output by a whole expert's share. The router-free run's
    errors and the share of its choices that differ from ``forward``'s
    come back as ``free_running``; that share is held to
    ZOO_FLIP_LIMIT, the errors are a finding."""
    cfg = model.cfg
    S = tok.shape[1] - 2
    fwd_routes: list = []
    with recording_routes(fwd_routes):
        x, _ = model.forward(params, tok, img=img)
    want = model._head(params, x[:, S - 1:])[..., :cfg.vocab]
    del x

    def run(window=lambda stop: None):
        window(S)
        lg, cache = model.prefill(params, tok[:, :S],
                                  model.init_cache(1, S + 2), img=img)
        got = [lg]
        for i in range(2):
            window(S + i + 1)
            lg, cache = model.decode_step(params, cache,
                                          tok[:, S + i:S + i + 1])
            got.append(lg)
        return logit_errors(torch.cat(got, 1)[..., :cfg.vocab], want)

    if cfg.moe is None:
        return run()
    n_moe = cfg.n_layers - len(cfg.dense_layers)
    fwd = routes_by_layer(fwd_routes, n_moe)
    routes: list = []
    with recording_routes(routes):
        free = run()
    free["expert_choices_differing"] = routing_share(
        routes_by_layer(routes, n_moe, steps=2), fwd, cfg.moe.n_routed)
    check(free["expert_choices_differing"] <= ZOO_FLIP_LIMIT,
          f"zoo {cfg.name} prefill + decode vs forward, routers free: "
          f"{free['expert_choices_differing']:.2%} of the expert choices "
          f"differ, limit {ZOO_FLIP_LIMIT:.0%}")
    if not replay:
        return free
    with replaying_routes(fwd) as window:
        err = run(window)
    return err | {"free_running": free}


def zoo_consistency(cfg, params, img, seed: int) -> dict:
    """Prefill of ZOO_CHECK_SEQ tokens + 2 decode steps against
    ``forward`` in bfloat16 on the model's parameters, at a capacity
    factor where no MoE token drops and with ``forward``'s expert
    choices replayed (:func:`prefill_vs_forward`); the LM slice's bf16
    limits."""
    cfg = no_drop(cfg)
    tok = lm_tokens(1, ZOO_CHECK_SEQ + 2, cfg.vocab, seed)
    err = prefill_vs_forward(build_model(cfg), params, tok,
                             None if img is None else img[:1], replay=True)
    free = err.pop("free_running", None)
    check(lm_bf16_ok(err), f"zoo {cfg.name} prefill + decode vs forward: "
          f"{err}")
    print(f"zoo {cfg.name} check: prefill {ZOO_CHECK_SEQ} + 2 decode steps "
          f"vs forward over {ZOO_CHECK_SEQ + 2} tokens, bf16 "
          f"{json.dumps(err)} tol {LM_BF16_TOL:g} (max abs, x max(1, "
          f"max|ref|); and relative L2) ok"
          + (f" (capacity factor {cfg.moe.capacity_factor:.4g}: no drops; "
             f"forward's expert choices replayed; routers free, the share "
             f"of choices differing held to {ZOO_FLIP_LIMIT:.0%}, the errors "
             f"a finding: {json.dumps(free)})" if free is not None else ""), flush=True)
    return err | ({"free_running": free} if free is not None else {})


def zoo_moe_f32(seed: int) -> dict:
    """(a) 1 in float32, where rounding moves no top-k choice: the MoE
    stack at full width cut to ZOO_F32_LAYERS layers, no drops, the
    router free (:func:`prefill_vs_forward`); the LM slice's float32
    limit."""
    cfg = no_drop(replace(get_arch(ZOO_MOE), n_layers=ZOO_F32_LAYERS,
                          param_dtype="float32", compute_dtype="float32"))
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    tok = lm_tokens(1, ZOO_CHECK_SEQ + 2, cfg.vocab, seed)
    err = prefill_vs_forward(model, params, tok, None, replay=False)
    check(err["max_abs_err"] <= LM_F32_TOL * max(1.0, err["max_abs_ref"]),
          f"zoo (a) f32 prefill + decode vs forward: {err}")
    print(f"zoo (a) {cfg.name} full width, {cfg.n_layers} layers, float32, "
          f"no drops: prefill {ZOO_CHECK_SEQ} + 2 decode steps vs forward "
          f"{json.dumps(err)} tol {LM_F32_TOL:g} x max(1, max|ref|) ok",
          flush=True)
    del model, params
    free_memory()
    return err


def zoo_k4_layer(cfg, blk: dict, x: torch.Tensor, label: str) -> dict:
    """K4 in the self layer ``blk`` at the model's shape (its q, k, v from
    the layer's input ``x``) against its plain version; the bf16 kernel
    tolerances of :func:`compare`."""
    B, S = x.shape[:2]
    q, k, v = attention._qkv(cfg, blk["attn"], apply_norm(cfg, blk["ln1"], x),
                             torch.arange(S, device="cuda"))
    args = [t.reshape(-1, S, cfg.d_head).contiguous() for t in (q, k, v)]
    check(args[0].shape[0] == B * cfg.n_heads
          and args[1].shape[0] == B * cfg.n_kv_heads,
          f"zoo {cfg.name} K4 shape {[a.shape for a in args]}")
    return compare("flash_attention_causal",
                   kernel_cfg("flash_attention_causal", {}), args, "bfloat16",
                   label)


def zoo_k4_vs_plain(model, params, tok) -> dict:
    """(a) 2 at the config's capacity factor: K4 in the first layer at the
    model's shape against its plain version; then the prefill of ``tok``
    with K4 against the same prefill with K4's plain version, routers
    free. The share of (token, k) expert choices that differ between the
    two is held to ZOO_FLIP_LIMIT; their last logits' errors are a
    finding (a choice that flips across a near tie moves a token by a
    whole expert's share)."""
    cfg = model.cfg
    n_moe = cfg.n_layers - len(cfg.dense_layers)
    out = {"k4_layer": zoo_k4_layer(cfg, params["dense_prefix"][0],
                                    model._embed(params, tok),
                                    "zoo MHA 16/16")}
    runs = []
    for plain in (False, True):
        routes: list = []
        snap = k4_snapshot()
        ctx = plain_attention() if plain else contextlib.nullcontext()
        with ctx, recording_routes(routes):
            lg, _ = model.prefill(params, tok, model.init_cache(*tok.shape))
        n, _ = k4_since(snap)
        check(n == (0 if plain else cfg.n_layers),
              f"zoo (a) {'plain' if plain else 'K4'} prefill launched K4 "
              f"{n} times")
        runs.append((lg[..., :cfg.vocab], routes_by_layer(routes, n_moe)))
    (got, k4), (want, ref_routes) = runs
    free = logit_errors(got, want)
    free["expert_choices_differing"] = routing_share(k4, ref_routes,
                                                     cfg.moe.n_routed)
    free["expert_choices"] = sum(r.numel() for r in k4)
    check(free["expert_choices_differing"] <= ZOO_FLIP_LIMIT,
          f"zoo (a) prefill with K4 vs plain, routers free: "
          f"{free['expert_choices_differing']:.2%} of the expert choices "
          f"differ, limit {ZOO_FLIP_LIMIT:.0%}")
    print(f"zoo (a) {cfg.name} prefill {tok.shape[0]} x {tok.shape[1]} at "
          f"capacity factor {cfg.moe.capacity_factor}: K4 vs its plain "
          f"version, routers free: expert choices differing "
          f"{free['expert_choices_differing']:.4%} (limit "
          f"{ZOO_FLIP_LIMIT:.0%}) ok; logits, a finding: {json.dumps(free)}",
          flush=True)
    return out | {"free_running": free}


def zoo_serve(model, params, n_req: int, mode: str) -> dict:
    """``ServeEngine(mode="auto")`` on 4 slots: ``n_req`` requests of 16
    tokens; the engine must pick ``mode``."""
    cfg = model.cfg
    eng = ServeEngine(model, params, n_slots=4, max_seq=256, mode="auto")
    rng = np.random.default_rng(0)
    for rid in range(n_req):
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(8, 33)),
                              dtype=np.int32)
        check(eng.submit(Request(rid, prompt, max_new_tokens=16)),
              f"request {rid} rejected")
    rep, sec = timed(eng.run)
    check(rep.requests_completed == n_req and rep.mode == mode
          and all(len(t) == 16 for t in rep.values()),
          f"zoo {cfg.name} serve: {rep.to_json()}")
    out = rep.to_json() | {"seconds": sec, "tok_s": n_req * 16 / sec}
    print(f"zoo {cfg.name} ServeEngine {rep.mode} mode (auto), 4 slots, "
          f"max_seq 256: {rep.requests_completed} requests, {rep.steps} "
          f"steps, occupancy {rep.occupancy}, {n_req * 16} tokens in "
          f"{sec:.2f} s ({out['tok_s']:.1f} generated tokens/s)", flush=True)
    return out


def zoo_prefill_line(cfg, tok, secs: list, dec_ms: float, prof: dict,
                     peak_gb: float) -> dict:
    ms = statistics.median(secs[1:]) * 1e3
    busy = prof["device_ms_per_step"]
    out = {"prefill_ms": ms, "prefill_runs_ms": [x * 1e3 for x in secs],
           "prefill_tok_s": tok.numel() / (ms / 1e3),
           "decode_ms_per_step": dec_ms, "peak_gb": peak_gb,
           "prefill_busy_ms": busy, "prefill_busy_share": busy / ms}
    print(f"zoo {cfg.name} bf16 x {cfg.n_layers} layers: prefill "
          f"{tok.shape[0]} x {tok.shape[1]} tokens in {ms:.1f} ms "
          f"({out['prefill_tok_s']:.0f} tokens/s; runs "
          f"{[round(x * 1e3, 1) for x in secs]} ms, the first a warm-up), "
          f"device busy {busy:.1f} ms ({busy / ms:.0%}); decode "
          f"{dec_ms:.2f} ms/step at batch {tok.shape[0]}; peak device "
          f"memory {peak_gb:.1f} GB", flush=True)
    return out


def zoo_moe() -> tuple[dict, tuple]:
    """(a) deepseek-moe-16b at full width and depth."""
    cfg = get_arch(ZOO_MOE)
    f32 = zoo_moe_f32(seed=23)
    model, params, n = zoo_model(cfg, seed=20)
    tok = lm_tokens(ZOO_BATCH, ZOO_SEQ, cfg.vocab, seed=21)
    snap = k4_snapshot()
    logits, cache, secs = zoo_prefills(model, params, tok, None,
                                       cfg.n_layers)
    dec_ms = zoo_decode(model, params, cache, logits, ZOO_DECODE)
    del cache
    prof = device_profile(lambda: model.prefill(
        params, tok, model.init_cache(ZOO_BATCH, ZOO_SEQ)),
        f"zoo {ZOO_MOE} prefill {ZOO_BATCH} x {ZOO_SEQ}", top=5,
        own="fa_wgmma_kernel")
    state = {"logits": logits,
             "cache": model.prefill(params, tok, model.init_cache(
                 ZOO_BATCH, ZOO_SEQ + 4))[1]}

    def decode_4():
        for _ in range(4):
            nxt = state["logits"][:, -1].argmax(-1, keepdim=True)
            state["logits"], state["cache"] = model.decode_step(
                params, state["cache"], nxt)

    prof_dec = device_profile(decode_4, f"zoo {ZOO_MOE} decode batch "
                              f"{ZOO_BATCH}", steps=4, top=5)
    del state
    out = {"n_params": n} | zoo_prefill_line(
        cfg, tok, secs, dec_ms, prof, torch.cuda.max_memory_allocated() / 1e9)
    out["profile_prefill"], out["profile_decode"] = prof, prof_dec
    out["decode_busy_share"] = prof_dec["device_ms_per_step"] / dec_ms
    out["serve"] = zoo_serve(model, params, 8, "token")
    launches = zoo_path_launches(cfg, snap, 5, cfg.n_layers)
    out["no_drop_f32"] = f32
    out["no_drop"] = zoo_consistency(cfg, params, None, seed=22)
    out["k4_vs_plain"] = zoo_k4_vs_plain(model, params, tok)
    del model, params, logits
    free_memory()
    return out, launches


def zoo_vision() -> tuple[dict, tuple]:
    """(b) llama-3.2-vision-11b at full width and depth, gates open."""
    cfg = get_arch(ZOO_VISION)
    groups = cfg.n_layers // cfg.cross_attn_period
    n_self = groups * (cfg.cross_attn_period - 1)
    model, params, n = zoo_model(cfg, seed=30)
    for cross in params["cross"]:
        cross["attn"]["gate"].fill_(ZOO_GATE)
    g = torch.Generator(device="cuda").manual_seed(31)
    img = torch.randn((ZOO_BATCH, cfg.n_img_tokens, cfg.d_model),
                      generator=g, device="cuda").to(torch.bfloat16)
    tok = lm_tokens(ZOO_BATCH, ZOO_SEQ, cfg.vocab, seed=32)
    snap = k4_snapshot()
    logits, cache, secs = zoo_prefills(model, params, tok, img, n_self)
    check(bool(cache["cross_kv"]["k"].abs().amax() > 0),
          "zoo (b) prefill did not write cross_kv")
    dec_ms = zoo_decode(model, params, cache, logits, ZOO_DECODE)
    del cache
    prof = device_profile(lambda: model.prefill(
        params, tok, model.init_cache(ZOO_BATCH, ZOO_SEQ), img=img),
        f"zoo {ZOO_VISION} prefill {ZOO_BATCH} x {ZOO_SEQ}", top=5,
        own="fa_wgmma_kernel")
    out = {"n_params": n, "self_layers": n_self} | zoo_prefill_line(
        cfg, tok, secs, dec_ms, prof, torch.cuda.max_memory_allocated() / 1e9)
    launches = zoo_path_launches(cfg, snap, 4, n_self)
    out["no_drop"] = zoo_consistency(cfg, params, img, seed=33)
    # K4 in the first self layer, at its GQA 32/8 shape, against its plain
    # version
    cross = params["cross"][0]
    x = model._cross_block(cross, model._embed(params, tok),
                           *attention.cross_kv(cfg, cross["attn"], img))
    out["k4_layer"] = zoo_k4_layer(cfg, params["layers"][0][0], x,
                                   "zoo GQA 32/8")
    del model, params, logits, x, img
    free_memory()
    return out, launches


def zoo_mla() -> tuple[dict, tuple]:
    """(c) deepseek-v2-236b at full width, ZOO_MLA_LAYERS layers."""
    cfg = replace(get_arch(ZOO_MLA), n_layers=ZOO_MLA_LAYERS)
    model, params, n = zoo_model(cfg, seed=40)
    tok = lm_tokens(ZOO_MLA_BATCH, ZOO_SEQ, cfg.vocab, seed=41)
    snap = k4_snapshot()
    logits, cache, secs = zoo_prefills(model, params, tok, None,
                                       ZOO_MLA_LAYERS)
    dec_ms = zoo_decode(model, params, cache, logits, ZOO_MLA_DECODE)
    del cache
    prof = device_profile(lambda: model.prefill(
        params, tok, model.init_cache(ZOO_MLA_BATCH, ZOO_SEQ)),
        f"zoo {ZOO_MLA} ({ZOO_MLA_LAYERS} layers) prefill {ZOO_MLA_BATCH} x "
        f"{ZOO_SEQ}", top=5)
    out = {"n_params": n} | zoo_prefill_line(
        cfg, tok, secs, dec_ms, prof, torch.cuda.max_memory_allocated() / 1e9)
    out["serve"] = zoo_serve(model, params, 4, "cohort")
    launches = zoo_path_launches(cfg, snap, 4, ZOO_MLA_LAYERS)
    out["no_drop"] = zoo_consistency(cfg, params, None, seed=42)
    del model, params, logits
    free_memory()
    return out, launches


def dropless_f32(cfg, p: dict, x: torch.Tensor) -> tuple:
    """The MoE FFN of x (B, S, D) in float32 as DeepSeek-V2 computes it:
    a float32 router, softmax, greedy top-k with no renormalisation,
    each routed expert run on exactly the tokens that chose it, plus the
    shared experts as one MLP. Returns (y (B*S, D), the pairs routed)."""
    e = cfg.moe
    check(not e.norm_topk_prob, f"{cfg.name}: renormalised gates")
    f = {k: t.float() for k, t in p.items()}
    xt = x.reshape(-1, x.shape[-1]).float()

    def mlp(h, w_in, w_gate, w_out):
        return (F.silu(h @ w_gate) * (h @ w_in)) @ w_out

    gate, sel = torch.topk(torch.softmax(xt @ f["router"], -1), e.top_k, -1)
    y = mlp(xt, f["shared_in"], f["shared_gate"], f["shared_out"])
    pairs = 0
    for j in range(e.n_routed):
        rows, slot = (sel == j).nonzero(as_tuple=True)
        pairs += rows.numel()
        y.index_add_(0, rows, gate[rows, slot, None] * mlp(
            xt[rows], f["w_in"][j], f["w_gate"][j], f["w_out"][j]))
    return y, pairs


def zoo_dropless() -> tuple[dict, tuple]:
    """(d) deepseek-v2-lite at full width, ZOO_DROPLESS_LAYERS layers:
    three prefills, each one K4 launch a layer at MLA's q/k 192 and v 128
    (wgmma), the last one's MoE layer against :func:`dropless_f32` on its
    own input."""
    cfg = replace(get_arch(ZOO_DROPLESS), n_layers=ZOO_DROPLESS_LAYERS)
    check(cfg.moe.capacity_factor is None,
          f"{cfg.name}: not the dropless dispatch")
    model, params, n = zoo_model(cfg, seed=45)
    tok = lm_tokens(ZOO_BATCH, ZOO_SEQ, cfg.vocab, seed=46)
    snap = k4_snapshot()
    seen, orig = [], moe_module.moe_ffn

    def keep(c, p, x):
        y, aux = orig(c, p, x)
        seen[:] = [(p, x, y)]
        return y, aux

    moe_module.moe_ffn = keep
    try:
        logits, cache, secs = zoo_prefills(model, params, tok, None,
                                           cfg.n_layers)
    finally:
        moe_module.moe_ffn = orig
    launches = zoo_path_launches(cfg, snap, 3, cfg.n_layers)
    del cache, logits
    (p, x, y), = seen
    want, pairs = dropless_f32(cfg, p, x)
    got = y.reshape(want.shape).float()
    gaps = ((got - want).norm(dim=-1) / want.norm(dim=-1))
    err = {"pairs": pairs, "tokens": x.shape[0] * x.shape[1],
           "rel_l2_err": float((got - want).norm() / want.norm()),
           "worst_row": float(gaps.max()),
           "rows_off": float((gaps > ZOO_DROPLESS_ROW_GAP).float().mean())}
    check(pairs == err["tokens"] * cfg.moe.top_k,
          f"zoo (d) {cfg.name}: {pairs} pairs routed, want "
          f"{err['tokens']} x {cfg.moe.top_k}")
    check(err["rows_off"] <= ZOO_DROPLESS_ROWS_OFF
          and err["rel_l2_err"] <= ZOO_DROPLESS_REL_L2,
          f"zoo (d) {cfg.name} dropless MoE layer vs float32 experts on "
          f"their own tokens: {err}")
    ms = statistics.median(secs[1:]) * 1e3
    print(f"zoo (d) {cfg.name} bf16 x {cfg.n_layers} layers (dense + one "
          f"dropless MoE layer): prefill {tok.shape[0]} x {tok.shape[1]} in "
          f"{ms:.1f} ms (runs {[round(t * 1e3, 1) for t in secs]} ms, the "
          f"first a warm-up), K4 {cfg.n_layers} wgmma launches a prefill at "
          f"q/k 192, v 128; its MoE layer vs float32 experts on their own "
          f"tokens {json.dumps(err)} (rows off by > "
          f"{ZOO_DROPLESS_ROW_GAP:g} held to {ZOO_DROPLESS_ROWS_OFF:g}; "
          f"whole tol {ZOO_DROPLESS_REL_L2:g}) ok", flush=True)
    out = {"n_params": n, "prefill_ms": ms, "dropless": err}
    del model, params, seen, p, x, y, want, got
    free_memory()
    return out, launches


def zoo_path_launches(cfg, snap: tuple, prefills: int, n_flash: int
                      ) -> tuple[int, Counter]:
    """K4's launches on a model's path since ``snap``, read before its
    checks: ``prefills`` prefills of ``n_flash`` wgmma bf16 launches each
    (the three timed, the profiled one, for MoE the decode profile's)
    and none while decoding or serving."""
    n, by = k4_since(snap)
    want = prefills * n_flash
    check(n == want and by[("wgmma", "bfloat16")] == want,
          f"zoo {cfg.name} path launched K4 {n} times ({dict(by)}), want "
          f"{want} ({prefills} prefills of {n_flash}), all wgmma bfloat16")
    return n, +by


def free_memory() -> None:
    """Return the blocks that dropped tensors freed to the card. Reference
    counts alone free a dropped train state
    (``test_a_dropped_train_state_is_freed_without_the_cycle_collector``),
    so no cycle collection runs here."""
    torch.cuda.empty_cache()


def phase_zoo(tmp: Path) -> dict:
    """Phase 12: the zoo's attention families on the card, one model at a
    time, from an empty wisdom directory (K4 in its default config)."""
    t0 = time.perf_counter()
    free_memory()
    held = torch.cuda.memory_allocated()
    print(f"phase 12 (the zoo) starts with {held / 1e9:.2f} GB allocated "
          f"(no cycle collection since phase 11)", flush=True)
    check(held < ZOO_START_MAX_GB * 1e9,
          f"{held / 1e9:.2f} GB still allocated after phase 11 dropped its "
          f"train state (a reference cycle?)")
    out = {}
    total, by = 0, Counter()
    with quickstart._env(**{WISDOM_DIR_ENV: str(tmp / "zoo-wisdom")}):
        ops.reload_wisdom()
        for name, fn in ((ZOO_MOE, zoo_moe), (ZOO_VISION, zoo_vision),
                         (ZOO_MLA, zoo_mla), (ZOO_DROPLESS, zoo_dropless)):
            t = time.perf_counter()
            out[name], (n, b) = fn()
            out[name]["seconds"] = time.perf_counter() - t
            total += n
            by += b
            print(f"zoo {name} took {out[name]['seconds']:.1f}s; K4 "
                  f"launched {n} times on its path "
                  f"({json.dumps({' '.join(k): v for k, v in b.items()})}); "
                  f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still "
                  f"allocated", flush=True)
    ops.reload_wisdom()
    out["launches"] = {"flash_attention": total}
    out["by_body"] = {" ".join(k): v for k, v in sorted(by.items())}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 12 (the zoo) took {out['seconds']:.1f}s", flush=True)
    return out


REC_HYMBA = "hymba-1.5b"
REC_RWKV = "rwkv6-7b"
REC_WHISPER = "whisper-base"
#: whisper's frames (its published encoder context) and prompt (under its
#: published decoder context of 448 tokens).
REC_FRAMES, REC_WHISPER_SEQ = 1500, 256
#: (a): hymba's f32 prompt runs 5 mamba chunks of 64; the 2 layers'
#: windows are global and 128, so the SWA layer slides over the prompt.
REC_F32_SEQ = {REC_HYMBA: 320, REC_RWKV: 64, REC_WHISPER: 64}
REC_F32_WINDOWS = (0, 128)
#: Prefills of 4 x 2048 timed a model: rwkv's wkv recurrence is a host
#: loop of 2 device operations a token and layer, so it is timed once (its
#: first run), to keep phase 13 near 150 s; the others get a warm-up and
#: two timed runs.
REC_PREFILL_RUNS = {REC_HYMBA: 3, REC_RWKV: 1, REC_WHISPER: 3}
#: Each model's weight seed (its recurrent constants: the seed + 1).
REC_SEEDS = {REC_HYMBA: 50, REC_RWKV: 60, REC_WHISPER: 70}
#: Most tokens a sequence of the profiled prefill: the profiler traces
#: every kernel, and hymba's scan passes and rwkv's token loop launch
#: their kernels in proportion to S, so a quarter of the timed prefill's
#: 2048 shows the same split in a quarter of the time (the busy share is
#: read against a timed prefill of the same length).
REC_PROFILE_SEQ = 512


def redraw_recurrent(params, seed: int) -> None:
    """Redraw, in place and from ``seed``, the recurrent parameters the
    reference initialises to constants that hide a wrong port: rwkv's
    ``mu`` and ``mu_c`` (uniform [0, 1): at 0 ``_mix`` returns x and a
    wrong token shift never shows), ``bonus``, ``decay_base`` (normal x
    0.5: at 0 the bonus term vanishes) and ``ln_x.scale`` (1 + normal x
    0.1); mamba's ``A_log``, ``dt_bias`` (normal x 0.5) and ``D_skip``
    (1 + normal x 0.1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for path, t in tree.leaves_with_paths(params):
        name = path.split("/")[-1]
        if name in ("mu", "mu_c"):
            t.copy_(torch.rand(t.shape, generator=g, device="cuda"))
        elif name in ("bonus", "decay_base", "dt_bias", "A_log"):
            t.copy_(0.5 * torch.randn(t.shape, generator=g, device="cuda"))
        elif name == "D_skip" or path.endswith("ln_x/scale"):
            t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=g,
                                            device="cuda"))


def rec_frames(b: int, t: int, d: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, t, d), generator=g, device="cuda").to(
        torch.bfloat16)


def rec_f32_check(name: str, seed: int) -> dict:
    """(a) at full width in float32 with 2 layers: prefill's last logits
    against the same prompt fed token by token through ``decode_step``
    (whisper: a 1-token prefill writes the cross K/V, then decode_step
    takes the rest)."""
    upd = dict(n_layers=2, param_dtype="float32", compute_dtype="float32")
    if name == REC_HYMBA:
        upd["windows"] = REC_F32_WINDOWS
    cfg = replace(get_arch(name), **upd)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    redraw_recurrent(params, seed + 1)
    S = REC_F32_SEQ[name]
    tok = lm_tokens(1, S, cfg.vocab, seed)
    ex = ({"frames": rec_frames(1, REC_FRAMES, cfg.d_model, seed).float()}
          if cfg.enc_dec else {})
    pre, _ = model.prefill(params, tok, model.init_cache(1, S), **ex)
    if cfg.enc_dec:
        lg, cache = model.prefill(params, tok[:, :1], model.init_cache(1, S),
                                  **ex)
        for i in range(1, S):
            lg, cache = model.decode_step(params, cache, tok[:, i:i + 1])
    else:
        lg = feed(model, params, tok, S)
    err = logit_errors(pre[..., :cfg.vocab], lg[..., :cfg.vocab])
    check(err["max_abs_err"] <= LM_F32_TOL * max(1.0, err["max_abs_ref"]),
          f"rec (a) {name} f32 prefill vs decode: {err}")
    print(f"rec (a) {name} full width, 2 layers, float32, {S} tokens"
          + (f" (windows {REC_F32_WINDOWS}; {S // mamba_module.chunk_len(S)}"
             f" mamba chunks of {mamba_module.chunk_len(S)})"
             if name == REC_HYMBA else "")
          + f": prefill vs decode_step {json.dumps(err)} tol {LM_F32_TOL:g} "
          f"x max(1, max|ref|) ok", flush=True)
    del model, params
    free_memory()
    return err


def rec_prefill_vs_forward(model, params, seed: int) -> dict:
    """Logit errors of a prefill of ZOO_CHECK_SEQ tokens and 2 decode
    steps against ``forward`` over the S + 2 tokens, and, as the floor,
    ``forward`` over the first S tokens against the same ``forward`` at
    its position S - 1: one function on two lengths, which differ only in
    how the mamba scan chunks (the reference's rule: 4 chunks of 128 at
    512, 257 of 2 at 514) and in the products' shapes."""
    cfg = model.cfg
    S = ZOO_CHECK_SEQ
    tok = lm_tokens(1, S + 2, cfg.vocab, seed)
    dtype = cdt(cfg)
    ex = ({"frames": rec_frames(1, REC_FRAMES, cfg.d_model, seed).to(dtype)}
          if cfg.enc_dec else {})
    x, _ = model.forward(params, tok, **ex)
    want = model._head(params, x[:, S - 1:])[..., :cfg.vocab]
    x, _ = model.forward(params, tok[:, :S], **ex)
    floor = logit_errors(model._head(params, x[:, S - 1:])[..., :cfg.vocab],
                         want[:, :1])
    del x
    lg, cache = model.prefill(params, tok[:, :S], model.init_cache(1, S + 2),
                              **ex)
    got = [lg]
    for i in range(2):
        lg, cache = model.decode_step(params, cache, tok[:, S + i:S + i + 1])
        got.append(lg)
    err = logit_errors(torch.cat(got, 1)[..., :cfg.vocab], want)
    return err | {"floor": floor}


def rec_depth_check(model, params, seed: int) -> dict:
    """(b) at full depth: :func:`rec_prefill_vs_forward` in float32 on the
    same weights (drawn in float32, then rounded for the bf16 model: the
    same seeds), within the f32 limit; and in bfloat16 on the model, its
    errors beside the floor, a finding. 32 layers of random weights
    amplify each bf16 rounding difference between two paths, and hymba's
    floor (two bf16 runs of one function) passes the LM slice's bf16
    limit, so bf16 cannot tell a wrong cache path from rounding there;
    float32 can."""
    cfg = model.cfg
    bf16 = rec_prefill_vs_forward(model, params, seed)
    f32_cfg = replace(cfg, param_dtype="float32", compute_dtype="float32")
    f32_model = build_model(f32_cfg)
    f32_params = f32_model.init(
        torch.Generator(device="cuda").manual_seed(REC_SEEDS[cfg.name]))
    redraw_recurrent(f32_params, REC_SEEDS[cfg.name] + 1)
    err = rec_prefill_vs_forward(f32_model, f32_params, seed)
    del f32_model, f32_params
    free_memory()
    check(err["max_abs_err"] <= LM_F32_TOL * max(1.0, err["max_abs_ref"]),
          f"rec (b) {cfg.name} f32 prefill + decode vs forward: {err}")
    check(all(math.isfinite(bf16[k]) for k in ("max_abs_err",
                                                "rel_l2_err")),
          f"rec (b) {cfg.name} bf16 logits not finite: {bf16}")
    print(f"rec (b) {cfg.name} check: prefill {ZOO_CHECK_SEQ} + 2 decode "
          f"steps vs forward over {ZOO_CHECK_SEQ + 2} tokens at full depth "
          f"({cfg.n_layers} layers), float32 {json.dumps(err)} tol "
          f"{LM_F32_TOL:g} x max(1, max|ref|) ok; bf16, a finding: "
          f"{json.dumps(bf16)} (the LM slice's bf16 limit "
          f"{LM_BF16_TOL:g})", flush=True)
    return {"float32": err, "bfloat16": bf16}


def rec_prefills(model, params, tok, ex: dict) -> tuple:
    """REC_PREFILL_RUNS prefills of ``tok``. Returns (logits, cache, the
    runs' seconds)."""
    cfg = model.cfg
    secs = []
    for _ in range(REC_PREFILL_RUNS[cfg.name]):
        cache = model.init_cache(tok.shape[0], tok.shape[1] + ZOO_DECODE)
        (logits, cache), sec = timed(lambda: model.prefill(params, tok,
                                                           cache, **ex))
        secs.append(sec)
    check(logits.shape == (tok.shape[0], 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          f"rec {cfg.name} prefill logits not finite or of the wrong shape")
    return logits, cache, secs


def rec_run(name: str, seed: int, serve: bool) -> dict:
    """One model of phase 13 at full width and depth in bfloat16: the
    timed prefills, ZOO_DECODE greedy decode steps, profiler windows of
    one prefill and one decode step, peak memory, ``ServeEngine`` in
    cohort mode (``serve``), then checks (a)-(c)."""
    cfg = get_arch(name)
    snap = k4_snapshot()
    f32 = rec_f32_check(name, seed + 7)
    model, params, n = zoo_model(cfg, seed)
    redraw_recurrent(params, seed + 1)
    out = {"n_params": n}
    if cfg.enc_dec:
        B, S = ZOO_BATCH, REC_WHISPER_SEQ
        frames = rec_frames(B, REC_FRAMES, cfg.d_model, seed + 2)
        ex = {"frames": frames}
        timed(lambda: model.encode(params, frames))
        mem, sec = timed(lambda: model.encode(params, frames))
        check(mem.shape == (B, REC_FRAMES, cfg.d_model)
              and bool(torch.isfinite(mem).all()),
              f"rec {name} encoder output not finite or of the wrong shape")
        out["encode_ms"] = sec * 1e3
        print(f"rec {name} encode of frames {tuple(frames.shape)}: "
              f"{sec * 1e3:.2f} ms (after a warm-up)", flush=True)
        del mem
    else:
        B, S = ZOO_BATCH, ZOO_SEQ
        ex = {}
    tok = lm_tokens(B, S, cfg.vocab, seed + 3)
    logits, cache, secs = rec_prefills(model, params, tok, ex)
    dec_ms = zoo_decode(model, params, cache, logits, ZOO_DECODE)
    state = {"cache": cache,
             "nxt": logits[:, -1].argmax(-1, keepdim=True)}
    del cache
    sp = min(S, REC_PROFILE_SEQ)
    prof = device_profile(lambda: model.prefill(
        params, tok[:, :sp], model.init_cache(B, sp + 1), **ex),
        f"rec {name} prefill {B} x {sp}", top=5)
    _, sec_p = timed(lambda: model.prefill(
        params, tok[:, :sp], model.init_cache(B, sp + 1), **ex))
    prof_dec = device_profile(lambda: model.decode_step(
        params, state["cache"], state["nxt"]), f"rec {name} decode batch {B}",
        top=5)
    del state
    ms = (statistics.median(secs[1:]) if len(secs) > 1 else secs[0]) * 1e3
    out |= {"prefill_shape": [B, S], "prefill_ms": ms,
            "prefill_runs_ms": [x * 1e3 for x in secs],
            "prefill_tok_s": tok.numel() / (ms / 1e3),
            "decode_ms_per_step": dec_ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "profile_shape": [B, sp],
            "prefill_busy_share": prof["device_ms_per_step"] / (sec_p * 1e3),
            "decode_busy_share": prof_dec["device_ms_per_step"] / dec_ms,
            "profile_prefill": prof, "profile_decode": prof_dec}
    if serve:
        out["serve"] = zoo_serve(model, params, 8, "cohort")
    n_k4, _ = k4_since(snap)
    check(n_k4 == 0, f"rec {name} path launched K4 {n_k4} times, want 0 "
          f"(d_head {cfg.d_head} is no flash head dim)")
    out["k4_launches"] = n_k4
    out["f32_prefill_vs_decode"] = f32
    out["prefill_vs_forward"] = rec_depth_check(model, params, seed + 4)
    n_k4, _ = k4_since(snap)
    check(n_k4 == 0, f"rec {name} checks launched K4 {n_k4} times")
    sv = out.get("serve")
    b32, b16 = (out["prefill_vs_forward"][k] for k in ("float32", "bfloat16"))
    print(f"rec {name} on {nvidia_smi()}: {n / 1e9:.4f} B parameters, bf16 "
          f"x {cfg.n_layers}"
          + (f"+{cfg.n_enc_layers}" if cfg.enc_dec else "")
          + f" layers; prefill {B} x {S} runs "
          f"{[round(x * 1e3, 1) for x in secs]} ms (timed: "
          f"{ms:.1f} ms, {out['prefill_tok_s']:.0f} tokens/s); decode "
          f"{dec_ms:.2f} ms/step at batch {B}; device busy "
          f"{out['prefill_busy_share']:.0%} of a prefill of {B} x {sp}, "
          f"{out['decode_busy_share']:.0%} of a decode step; top prefill "
          f"kernels {json.dumps(prof['top'])}; peak {out['peak_gb']:.2f} GB"
          + (f"; served {sv['requests_completed']} requests in "
             f"{sv['mode']} mode, {sv['steps']} steps, "
             f"{sv['tok_s']:.1f} tokens/s" if sv else "")
          + f"; (a) {f32['max_abs_err']:.3g} of max|ref| "
          f"{f32['max_abs_ref']:.3g}; (b) f32 max abs {b32['max_abs_err']:.3g}"
          f" of {b32['max_abs_ref']:.3g}, bf16 rel L2 {b16['rel_l2_err']:.3g}"
          f" (floor {b16['floor']['rel_l2_err']:.3g}); (c) K4 launches 0",
          flush=True)
    del model, params, logits
    free_memory()
    return out


def phase_recurrent() -> dict:
    """Phase 13: the recurrent and encoder-decoder families on the card,
    one model at a time at full width and depth, each freed before the
    next."""
    t0 = time.perf_counter()
    free_memory()
    print(f"phase 13 (recurrent and enc-dec) on {nvidia_smi()} starts with "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)
    out = {}
    for name, serve in ((REC_HYMBA, True), (REC_RWKV, True),
                        (REC_WHISPER, False)):
        t = time.perf_counter()
        out[name] = rec_run(name, seed=REC_SEEDS[name], serve=serve)
        out[name]["seconds"] = time.perf_counter() - t
        print(f"rec {name} took {out[name]['seconds']:.1f}s; "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still "
              f"allocated", flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 13 (recurrent and enc-dec) took {out['seconds']:.1f}s",
          flush=True)
    return out


#: (a): the production-mesh cells dry-run on ``meta`` under a fake group:
#: (arch, shape, multi-pod).
DRY_CELLS = (("codeqwen1.5-7b", "train_4k", False),
             ("codeqwen1.5-7b", "prefill_32k", False),
             ("codeqwen1.5-7b", "decode_32k", False),
             ("deepseek-moe-16b", "train_4k", False),
             ("codeqwen1.5-7b", "train_4k", True))
#: (b): codeqwen1.5-7b's cells on the 1x1 debug mesh on the card, each
#: cut (global batch; layers, where given) to fit the card's 80 GB.
DEBUG_CUTS = {"prefill_32k": {"global_batch": 1},
              "decode_32k": {"global_batch": 2},
              "train_4k": {"global_batch": 8, "n_layers": 2}}
#: The reference's bound on counted over model FLOPs
#: (``tests/test_sharding_dryrun.py``).
FLOPS_BOUND = (0.8, 8.0)
LAUNCH_SEED = 140


def flops_in_bound(rec: dict, label: str) -> float:
    """Counted FLOPs over all chips against ``model_flops``: within
    :data:`FLOPS_BOUND`, or raise. Returns the ratio."""
    ratio = rec["hlo_walk"]["flops"] * rec["chips"] \
        / rec["roofline"]["model_flops"]
    lo, hi = FLOPS_BOUND
    check(lo < ratio < hi, f"{label}: counted flops are {ratio:.3g} x "
          f"model_flops, outside ({lo}, {hi})")
    return ratio


def launch_specs_check() -> dict:
    """(a) Every architecture's parameter specs (train and serve) and the
    caches of decode_32k and long_500k, where they run, divide on both
    production meshes."""
    shapes = {arch: (params_shape(get_arch(arch)), [
        input_specs(get_arch(arch), SHAPES[name])["cache"]
        for name in ("decode_32k", "long_500k")
        if cell_skip_reason(get_arch(arch), SHAPES[name]) is None])
        for arch in list_archs()}
    out = {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        n = 0
        for arch, (params, caches) in shapes.items():
            cfg = get_arch(arch)
            trees = [(params, sharding.param_pspecs(params, mesh, cfg)),
                     (params, sharding.param_pspecs(params, mesh, cfg,
                                                    serve=True))]
            trees += [(c, sharding.cache_pspecs(c, mesh)) for c in caches]
            for tree_, specs in trees:
                bad = sharding.validate_specs(tree_, specs, mesh)
                check(bad == [], f"{arch} specs on "
                      f"{tuple(mesh.mesh.shape)}: {bad[:3]}")
                n += 1
        out["multipod" if multi_pod else "singlepod"] = n
    print(f"launch specs: every spec divides on both production meshes "
          f"({json.dumps(out)} trees of parameters and caches)", flush=True)
    return out


def launch_dry_cell(rec: dict) -> dict:
    """(a) One production-mesh cell's record, from its own process on
    ``meta``: ok, in the flops bound, collectives > 0."""
    label = f"dry-run {rec['arch']} x {rec['shape']} on {rec['mesh_tag']}"
    check(rec["status"] == "ok",
          f"{label}: {rec.get('error')}\n{rec.get('where', '')}")
    label += f" {tuple(rec['mesh'].values())}"
    ratio = flops_in_bound(rec, label)
    coll = rec["collective_bytes"]
    check(coll["total"] > 0, f"{label}: no collective bytes")
    roof = rec["roofline"]
    print(f"{label}: {rec['lower_s']:.1f} s counting, {rec['wall_s']:.1f} s "
          f"in its process; flops/chip "
          f"{rec['hlo_walk']['flops']:.4g} ({ratio:.3f} x model_flops "
          f"{roof['model_flops']:.4g} over {rec['chips']} chips), bytes/chip "
          f"{rec['hlo_walk']['bytes_fused']:.4g}, collective bytes/chip "
          f"{json.dumps({k: v for k, v in coll.items() if v})}, arguments "
          f"{rec['memory_analysis']['argument_bytes'] / 2**30:.3f} GiB; on "
          f"H100 peaks compute {roof['compute_s']:.4g} s, memory "
          f"{roof['memory_s']:.4g} s, collective {roof['collective_s']:.4g}"
          f" s, dominant {roof['dominant']}, roofline fraction "
          f"{roof['roofline_fraction']:.4f}", flush=True)
    return rec


def debug_cell(name: str):
    """(b)'s config and shape of one cut codeqwen cell."""
    cut = dict(DEBUG_CUTS[name])
    cfg = get_arch(LM_ARCH)
    if "n_layers" in cut:
        cfg = replace(cfg, n_layers=cut.pop("n_layers"))
    return cfg, replace(SHAPES[name], **cut)


def launch_debug_cell(name: str, mesh) -> dict:
    """(b) One cut codeqwen cell on the card's 1x1 debug mesh: counted
    (K4 through its workload hook), then timed after that warm-up."""
    cfg, shape = debug_cell(name)
    snap = k4_snapshot()
    bwd = _build.CUDA_KERNELS["flash_attention_bwd"]
    bwd0 = bwd.launches
    rec = lower_cell(LM_ARCH, name, mesh, verbose=False, cfg=cfg,
                     shape=shape, seed=LAUNCH_SEED)
    n_k4, by = k4_since(snap)
    n_bwd = bwd.launches - bwd0
    label = (f"debug mesh {LM_ARCH} x {name} ({cfg.n_layers} layers, "
             f"batch {shape.global_batch} x {shape.seq})")
    check(rec["status"] == "ok", f"{label}: {rec.get('error')}")
    ratio = flops_in_bound(rec, label)
    hooked = sum(n for b, n in rec["kernel_launches"].items()
                 if b in ("flash_attention_causal", "flash_attention_full"))
    if shape.kind != "decode":
        check(n_k4 > 0, f"{label}: K4 was not launched")
    # the counted run and the timed run launch K4 alike
    check(n_k4 == 2 * hooked, f"{label}: K4 launched {n_k4} times over two "
          f"runs, its workload hook counted {hooked} in one")
    hooked_bwd = sum(n for b, n in rec["kernel_launches"].items()
                     if b.startswith("flash_attention_bwd_"))
    check(n_bwd == 2 * hooked_bwd and (n_bwd > 0) == (shape.kind == "train"),
          f"{label}: the backward kernel launched {n_bwd} times over two "
          f"runs, its workload hook counted {hooked_bwd} in one")
    if "loss" in rec:
        check(math.isfinite(rec["loss"]), f"{label}: loss {rec['loss']}")
    roof = rec["roofline"]
    ideal_s = roof["model_flops"] / HW().peak_flops_bf16
    rec |= {"k4_launches": n_k4, "bwd_launches": n_bwd,
            "k4_by_body": {" ".join(k): v for k, v in by.items()},
            "ideal_s": ideal_s, "flops_ratio": ratio}
    print(f"{label} on {nvidia_smi()}: counted flops "
          f"{rec['hlo_walk']['flops']:.4g} ({ratio:.3f} x model_flops "
          f"{roof['model_flops']:.4g}), bytes "
          f"{rec['hlo_walk']['bytes_fused']:.4g}"
          f"; on H100 peaks compute {roof['compute_s']:.4g} s, memory "
          f"{roof['memory_s']:.4g} s, collective {roof['collective_s']:.4g} "
          f"s, dominant {roof['dominant']}; step {rec['step_s']:.4f} s "
          f"(after the counted run), ideal_s {ideal_s:.4g} s = "
          f"{ideal_s / rec['step_s']:.4f} of the step; peak "
          f"{rec['peak_bytes'] / 1e9:.2f} GB; K4 {n_k4} launches over the "
          f"two runs {json.dumps(rec['k4_by_body'])}, {hooked} through its "
          f"workload hook in the counted run; its backward {n_bwd} launches"
          + (f"; loss {rec['loss']:.4f}" if "loss" in rec else ""),
          flush=True)
    free_memory()
    return rec


def start_dry_cells(tmp: Path) -> tuple:
    """Phase 14 (a)'s cells, each in a process of its own on the host's
    cores (``meta`` tensors: the card is not touched). They are started
    before phase 13, so they count while phase 13 and (b) use the card.
    Returns the pool and the cells' futures."""
    pool = ThreadPoolExecutor(max_workers=len(DRY_CELLS))
    return pool, [pool.submit(run_cell_process, arch, name, multi_pod,
                              tmp / "dryrun")
                  for arch, name, multi_pod in DRY_CELLS]


def phase_launch(tmp: Path, dry_cells: tuple) -> dict:
    """Phase 14: the multi-device launcher and the roofline. (a) The
    production meshes on ``meta`` under fake process groups, their cells
    started by :func:`start_dry_cells`; (b) codeqwen1.5-7b's cells on the
    card's 1x1 debug mesh, then each counted on ``meta`` under a fake 1x1
    mesh."""
    t0 = time.perf_counter()
    free_memory()
    pool, dry = dry_cells
    out = {"specs": launch_specs_check(), "dry": {}, "debug": {}}
    release()
    total, total_bwd, by = 0, 0, Counter()
    with quickstart._env(**{WISDOM_DIR_ENV: str(tmp / "launch-wisdom")}):
        ops.reload_wisdom()
        mesh = make_debug_mesh(device="cuda")
        for name in DEBUG_CUTS:
            rec = launch_debug_cell(name, mesh)
            out["debug"][name] = rec
            total += rec["k4_launches"]
            total_bwd += rec["bwd_launches"]
            by += Counter(rec["k4_by_body"])
        mesh = make_fake_mesh((1, 1), ("data", "model"))
        for name, rec in out["debug"].items():
            cfg, shape = debug_cell(name)
            meta = lower_cell(LM_ARCH, name, mesh, verbose=False, cfg=cfg,
                              shape=shape)
            rec["meta_flops"] = meta["hlo_walk"]["flops"]
            rec["meta_bytes"] = meta["hlo_walk"]["bytes_fused"]
            print(f"debug mesh {LM_ARCH} x {name}: flops on the card "
                  f"{rec['hlo_walk']['flops']:.6g}, on meta "
                  f"{rec['meta_flops']:.6g} (microbatches by trip count); "
                  f"bytes {rec['hlo_walk']['bytes_fused']:.6g} and "
                  f"{rec['meta_bytes']:.6g}; meta counted in "
                  f"{meta['lower_s']:.1f} s", flush=True)
        release()
    ops.reload_wisdom()
    for future in dry:
        rec = launch_dry_cell(future.result())
        out["dry"][f"{rec['arch']} {rec['shape']} {rec['mesh_tag']}"] = rec
    pool.shutdown()
    out["launches"] = {"flash_attention": total,
                       "flash_attention_bwd": total_bwd}
    out["by_body"] = dict(by)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 14 (launcher and roofline) took {out['seconds']:.1f}s",
          flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE float32 products
    t0 = time.perf_counter()
    # torch's lazy import of torch._dynamo pins the frames that trigger it
    # (train/step.py): trigger it here, off every phase's stack
    import_dynamo_off_stack()
    phase_environment()
    phase_build()
    headline = phase_kernels()
    wide = phase_wide_flash()
    mla_row = phase_mla_flash()
    bwd_row = phase_flash_backward()
    headline["flash_attention_bwd"] = bwd_row["max_abs_err"]
    print(f"[{time.perf_counter() - t0:.0f}s] kernels agree with their "
          f"plain versions", flush=True)
    with tempfile.TemporaryDirectory(prefix="kl-smoke-") as tmp:
        wisdom = Path(tmp) / "wisdom"
        reg, tr, pr = instrument()
        qs, mh, counts = phase_main_path(wisdom)
        by = launches_by(LOOP_KERNELS)
        paths = [("main", len(pr.profiles))]
        stats = Counter({"matmul": len(qs["stats"])})
        stats.update(name for name, *_ in mh["launched"])
        stats["diff_uvw"] += both_diff_kernels(mh, wisdom / "microhh")
        paths.append(("forced", len(pr.profiles)))
        print(f"[{time.perf_counter() - t0:.0f}s] main path done", flush=True)
        _build.reset_launch_counts()
        ops_stats0 = {k: len(k.stats) for k in ops._ALL_KERNELS}
        lm_wisdom = Path(tmp) / "lm-wisdom"
        lm = phase_lm(lm_wisdom)
        stats.update({k.builder.name: len(k.stats) - n
                      for k, n in ops_stats0.items() if len(k.stats) > n})
        paths.append(("lm", len(pr.profiles)))
        uninstrument()
        lm_counts = {k: _build.CUDA_KERNELS[k].launches for k in LM_KERNELS}
        print(f"lm-path launches: {json.dumps(lm_counts)}; flash_attention "
              f"by body: {json.dumps(flash_attention.BODY_LAUNCHES)}",
              flush=True)
        for name, n in lm_counts.items():
            check(n > 0, f"{name} was not launched on the LM path")
        counts |= lm_counts
        by |= launches_by(LM_KERNELS)
        print(f"[{time.perf_counter() - t0:.0f}s] LM path done", flush=True)
        rows = phase_times(qs, mh)
        rows[("flash_attention", 2048, "bfloat16")] = phase_lm_times(lm)
        rows[("flash_attention_bwd", 2048, "bfloat16")] = bwd_row
        t7 = time.perf_counter()
        phase_telemetry(reg, tr, pr, stats, paths, lm["serve"]["cohorts"])
        phase_export(current_device_kind(), wisdom, Path(tmp) / "generated")
        print(f"[{time.perf_counter() - t0:.0f}s] phase 7 (telemetry, "
              f"profiles, export) took {time.perf_counter() - t7:.1f}s",
              flush=True)
        phase_online(wisdom / "microhh", Path(tmp))
        phase_recorded(Path(tmp))
        phase_fleet(Path(tmp), wisdom / "microhh", lm_wisdom)
        train = phase_train(Path(tmp))
        print(f"train-path launches: {json.dumps(train['launches'])}; "
              f"flash_attention by body: {json.dumps(train['by_body'])}",
              flush=True)
        for name, n in train["launches"].items():
            check(n > 0, f"{name} was not launched on the training path")
        counts["flash_attention_bwd"] = train["launches"][
            "flash_attention_bwd"]
        zoo = phase_zoo(Path(tmp))
        print(f"zoo-path launches: {json.dumps(zoo['launches'])}; "
              f"flash_attention by body: {json.dumps(zoo['by_body'])}",
              flush=True)
        for name, n in zoo["launches"].items():
            check(n > 0, f"{name} was not launched on the zoo's path")
            counts[name] += n
        for key, n in zoo["by_body"].items():
            by["flash_attention"][key] = by["flash_attention"].get(key, 0) + n
        dry_cells = start_dry_cells(Path(tmp))
        phase_recurrent()
        launch = phase_launch(Path(tmp), dry_cells)
        print(f"launch-path launches: {json.dumps(launch['launches'])}; "
              f"flash_attention by body: {json.dumps(launch['by_body'])}",
              flush=True)
        for name, n in launch["launches"].items():
            check(n > 0, f"{name} was not launched on the launcher's path")
            counts[name] += n
        by["flash_attention_bwd"] = {"bfloat16":
                                     counts["flash_attention_bwd"]}
        for key, n in launch["by_body"].items():
            by["flash_attention"][key] = by["flash_attention"].get(key, 0) + n
    kernels = []
    for name in TPU_KERNELS:
        key = ((name, 2048, "bfloat16") if name.startswith("flash_attention")
               else (name, 512, "float32"))
        row = rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCES[name]}",
            "replaces": TPU_KERNELS[name], "launches": counts[name],
            "launches_by_body_dtype": by[name],
            "max_abs_err": headline[name], "ms": row["tuned_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    for (d, dtype), row in wide.items():
        kernels.append({
            "name": f"flash_attention_d{d}_{dtype}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": TPU_KERNELS["flash_attention"],
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    kernels.append({
        "name": f"flash_attention_d{mla_row['head_dim']}"
                f"v{mla_row['v_dim']}_{mla_row['dtype']}",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": TPU_KERNELS["flash_attention"],
        "launches": mla_row["launches"] * len(FA_MLA_SHAPES),
        "max_abs_err": mla_row["max_abs_err"], "ms": mla_row["ms"],
        "plain_ms": mla_row["plain_ms"], "bound_ms": mla_row["bound_ms"],
        "bound_by": mla_row["bound_by"], "library_ms": mla_row["library_ms"],
    })
    print(f"[{time.perf_counter() - t0:.0f}s] done", flush=True)
    print(nvidia_smi())   # name, power limit: as nvidia-smi prints them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == TRAIN_RESUME_FLAG:
        sys.exit(train_resume_child(Path(sys.argv[2])))
    sys.exit(main())
