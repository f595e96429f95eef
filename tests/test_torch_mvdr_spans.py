"""MVDR's spans and its solve counter (``models/mvdr.py``).  That a pipeline
block in ``heatmap_mode="mvdr"`` opens ``awpu.estimator.covariance``,
``.factor`` and ``.directions`` once each inside ``awpu.estimator`` is
``tests/test_torch_spans.py``'s estimator case; here:

- ``MvdrStep.solves`` counts the direction stages: 6 over 6 blocks at
  ``weight_refresh`` 1, 2 at 4, through ``scan`` too;
- with no profiler running the step dispatches the same operators, in the
  same order, as a step whose spans are plain no-ops (each operator a
  kernel launch on the card), and its outputs equal bit for bit;
- on the card (marked ``card``, skipped without one): a block of the
  eager step makes no sync (the graphed step's replay is
  ``tests/test_torch_mvdr_graph.py``'s).

The card test imports no JAX: run it on the card with
``python -m pytest tests/test_torch_mvdr_spans.py -q -m card --noconftest``.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from beamforming_lk_tpu_torch.app import AwpuPipeline  # noqa: E402
from beamforming_lk_tpu_torch.config import ArrayConfig, Config, MimoConfig, realtime  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models import mvdr as mv  # noqa: E402
from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from tests.test_torch_swarm_graph import card  # noqa: E402, F401

ACFG = ArrayConfig()
POINTS = ant.create_antenna_grid(4, 4, 0.02)


def _step(refresh: int = 1, points=POINTS, device="cpu"):
    theta, phi = make_mimo_grid(MimoConfig(rows=8, columns=8))
    return mv.MvdrStep(points, theta, phi, ACFG, weight_refresh=refresh,
                       device=device)


def _blocks(n: int, points=POINTS, device="cpu"):
    rng = np.random.default_rng(5)
    return [torch.as_tensor(plane_wave_block(
        points, [(0.5, 1.2, 5000.0)], i * 256, 256, ACFG, noise_std=0.05, rng=rng),
        device=device) for i in range(n)]


@pytest.mark.parametrize("refresh, solves", [(1, 6), (4, 2)])
def test_solves_counts_the_direction_stages(refresh, solves):
    step = _step(refresh)
    state = step.init()
    counted = []
    for block in _blocks(6):
        state, _ = step(state, block)
        counted.append(step.solves)
    assert counted[-1] == solves
    assert counted == [1 + i // refresh for i in range(6)]
    scanned = _step(refresh)
    scanned.scan(scanned.init(), torch.stack(_blocks(6)))
    assert scanned.solves == solves


class _Ops(TorchDispatchMode):
    """The operators dispatched inside the mode, by name, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _run_with_ops(step, blocks):
    ops, state, out = _Ops(), step.init(), []
    with ops:
        for block in blocks:
            state, powers = step(state, block)
            out.append((state.cov_re, state.cov_im, powers))
    return ops.names, out


def test_spans_add_no_operator_and_leave_the_outputs_bit_for_bit(monkeypatch):
    blocks = _blocks(3)
    with_spans = _run_with_ops(_step(), blocks)
    monkeypatch.setattr(mv, "span", lambda name: contextlib.nullcontext())
    without = _run_with_ops(_step(), blocks)
    assert with_spans[0] == without[0] and len(with_spans[0]) > 0
    for got, want in zip(with_spans[1], without[1]):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.card
def test_an_mvdr_block_makes_no_sync_on_the_card(card):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` a block of the
    ``lk256-mvdr`` estimator (256 mics, the 64 x 64 grid) on the eager path,
    spans and counter included, raises nothing."""
    pipe = AwpuPipeline(realtime(Config()), channels=256, heatmap_mode="mvdr",
                        device=card)
    step = pipe._mvdr_step
    step.graphs = None
    blocks = _blocks(2, pipe.points, device=card)
    state, _ = step(step.init(), blocks[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, powers = step(state, blocks[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert step.solves == 2 and bool(torch.isfinite(powers).all())
