"""The card's case for the program's spans: ``python -m pytest -m gpu
klbench/tests`` on a machine with an H100. It skips without a CUDA
device."""

import pytest

pytestmark = pytest.mark.gpu


def test_program_spans_and_the_device_trace_share_one_clock(cuda):
    """In a traced stencil step each kernel joins the program's
    ``repro_torch.enqueue`` span that launched it by correlation id, and
    the launch's ``repro_torch.sync`` span ends after that kernel's device
    end. The profiler may shift the device's clock against the host's (by
    up to milliseconds in some sessions); a kernel never starts before its
    launch call, so the smallest launch-to-start delay of the window bounds
    that shift, and the comparison takes it out."""
    import torch

    from klbench.trace import Profiled
    from repro_torch.kernels import ops
    u, v, w, evisc = torch.rand((4, 128, 128, 128), device=cuda).unbind(0)
    scal = (1.1, 0.9, 1.3)
    ops.advec_u(u, v, w, *scal)               # builds or loads both
    ops.diff_uvw(u, v, w, evisc, *scal)
    torch.cuda.synchronize()
    with Profiled() as p:
        for _ in range(3):
            ops.advec_u(u, v, w, *scal)
            ops.diff_uvw(u, v, w, evisc, *scal)
        torch.cuda.synchronize()
    view = p.view
    enqueues = sorted(view.ranges["repro_torch.enqueue"], key=lambda r: r.ts)
    syncs = sorted(view.ranges["repro_torch.sync"], key=lambda r: r.ts)
    assert len(enqueues) == len(syncs) == 6
    assert len(view.ranges["repro_torch.launch"]) == 6
    assert len(view.ranges["repro_torch.scalars"]) == 6
    shift = min(k.ts - call.ts for call in view.launches
                for k in view.kernels_by_corr.get(call.corr, ()))
    for enq, sync in zip(enqueues, syncs):
        kernels = view.kernels_in(enq)
        assert kernels, enq
        assert sync.tid == enq.tid and sync.ts >= enq.end
        assert sync.end >= max(k.end for k in kernels) - shift, (
            sync, kernels, shift)
