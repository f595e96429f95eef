"""MVDR's step replayed as a CUDA graph (``models/mvdr.py::MvdrStep.forward``,
``utils/graphs.py``):

- on the CPU: that the CPU and a bin-sharded step stay eager (nothing
  captured, nothing replayed, the count and the solves as the eager step
  counts them); and, with a recorded stand-in for the graph
  (``test_torch_swarm_graph._Recorded``), that the replayed step equals the
  eager one bit for bit over a cold block and warm ones at
  ``weight_refresh`` 1 and 4,
  that ``count`` and ``solves`` count on through replays, and that a call's
  state and powers are not overwritten by the next call;
- on the card (marked ``card``, skipped without one): the graphed step at
  256 mics in the ``lk256-mvdr`` configuration against the eager one, bit
  for bit over 200 blocks from the cold one on at refresh 1 and over 40 at
  refresh 4, and a replayed block that makes no sync.

The card tests import no JAX: run them on the card with
``python -m pytest tests/test_torch_mvdr_graph.py -q -m card --noconftest``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from beamforming_lk_tpu_torch.app import AwpuPipeline  # noqa: E402
from beamforming_lk_tpu_torch.config import ArrayConfig, Config, MimoConfig, realtime  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models import mvdr as mv  # noqa: E402
from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from tests.test_torch_swarm_graph import (  # noqa: E402, F401
    _Recorded, _leaves, _recorded_capture, card, world1,
)

ACFG = ArrayConfig()
POINTS = ant.create_antenna_grid(4, 4, 0.02)
SOURCES = [(0.5, 1.2, 5000.0), (0.8, 2.0, 3000.0)]


def _step(refresh: int = 1, points=POINTS, device="cpu"):
    theta, phi = make_mimo_grid(MimoConfig(rows=8, columns=8))
    step, _ = mv.make_mvdr_step(points, theta, phi, ACFG,
                                weight_refresh=refresh, device=device)
    return step


def _blocks(n: int, points=POINTS, device="cpu"):
    rng = np.random.default_rng(7)
    return [torch.as_tensor(plane_wave_block(
        points, SOURCES, i * 256, 256, ACFG, noise_std=0.02, rng=rng),
        device=device) for i in range(n)]


def _counts(step):
    g = step.graphs
    return (0, 0) if g is None else (g.captures, g.replays)


def _solves(refresh: int, blocks: int) -> int:
    """Direction stages of ``blocks`` blocks from the cold one on."""
    return -(-blocks // refresh)


def _warm_keys(refresh: int) -> int:
    """Host keys of the warm blocks: whether a block solves, at refresh k > 1."""
    return 1 if refresh == 1 else 2


@pytest.fixture
def recorded(monkeypatch):
    """A CUDA graph stood in by :class:`_Recorded` on the CPU."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Recorded)
    monkeypatch.setattr(torch.cuda, "graph", _recorded_capture)


@pytest.mark.parametrize("refresh", [1, 4])
@pytest.mark.parametrize("case,graphed", [("dense", True), ("shard", False)])
def test_the_cpu_and_a_shard_stay_eager(request, case, graphed, refresh):
    """The step on one device gets its graphs, a bin-sharded step none; on
    the CPU every block runs eagerly: nothing captured, nothing replayed,
    and the count and the solves as the eager step counts them."""
    if case == "shard":
        from beamforming_lk_tpu_torch.parallel import make_mesh

        request.getfixturevalue("world1")
        mesh = make_mesh((1,), axis_names=("dir",), device_type="cpu")
        theta, phi = make_mimo_grid(MimoConfig(rows=8, columns=8))
        step, state = mv.make_sharded_mvdr_step(POINTS, theta, phi, mesh,
                                                array_cfg=ACFG,
                                                weight_refresh=refresh,
                                                device="cpu")
    else:
        step = _step(refresh)
        state = step.init()
    assert (step.graphs is not None) == graphed
    for block in _blocks(6):
        state, _ = step(state, block)
    assert _counts(step) == (0, 0)
    assert state.count == 6
    assert step.solves == _solves(refresh, 6)


def _equal(got, want):
    """Two ``(MvdrState, powers)`` pairs equal bit for bit, count and all."""
    (gs, gp), (ws, wp) = got, want
    assert gs.count == ws.count
    assert (gs.powers is None) == (ws.powers is None)
    for a, b in zip(_leaves(gs, gp), _leaves(ws, wp), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("refresh", [1, 4])
def test_a_recorded_replay_equals_the_eager_step(recorded, refresh):
    """With :class:`_Recorded` in place of a CUDA graph, a cold block and 8
    warm ones through ``MvdrStep._replay`` against the eager step from one
    state: state, count and powers equal bit for bit every block; each host
    key's first block runs eagerly, its second captures, and every later
    one replays (at refresh 1: 1 capture, 7 replays)."""
    eager, graphed = _step(refresh), _step(refresh)
    want = got = (eager.init(), None)
    for block in _blocks(9):
        want = eager._step(want[0], block)
        got = graphed._replay(got[0], block)
        _equal(got, want)
    keys = _warm_keys(refresh)
    assert _counts(graphed) == (keys, 9 - 1 - keys)


@pytest.mark.parametrize("refresh", [1, 4])
def test_count_and_solves_count_on_through_replays(recorded, refresh):
    """``count`` reads the blocks folded in and ``solves`` one a block at
    refresh 1, one in 4 at refresh 4, replayed or not."""
    step, n = _step(refresh), 13
    state = step.init()
    seen = []
    for block in _blocks(n):
        state, _ = step._replay(state, block)
        seen.append((state.count, step.solves))
    assert seen == [(i + 1, _solves(refresh, i + 1)) for i in range(n)]
    keys = _warm_keys(refresh)
    assert _counts(step) == (keys, n - 1 - keys)


@pytest.mark.parametrize("refresh", [1, 4])
def test_a_replay_leaves_earlier_results_alone(recorded, refresh):
    """The state and powers a call returned read the same after every later
    call, replays included."""
    step = _step(refresh)
    state, held = step.init(), []
    for block in _blocks(9):
        state, powers = step._replay(state, block)
        for tensors, copies in held:
            assert all(torch.equal(a, b) for a, b in zip(tensors, copies))
        held.append((_leaves(state, powers),
                     [x.clone() for x in _leaves(state, powers)]))
    assert _counts(step)[1] > 0


def _cell_steps(device, refresh: int = 1):
    """The ``lk256-mvdr`` estimator (``realtime(Config())`` at 256 mics,
    Capon at ``mvdr_refresh``) as the pipeline builds it, and a twin with
    its graphs taken away."""
    pipe = AwpuPipeline(realtime(Config()), channels=256, heatmap_mode="mvdr",
                        mvdr_refresh=refresh, device=device)
    graphed = pipe._mvdr_step
    theta, phi = make_mimo_grid(pipe.cfg.mimo)
    eager, _ = mv.make_mvdr_step(pipe.points, theta, phi, pipe.cfg.array,
                                 weight_refresh=refresh, device=device)
    eager.graphs = None
    return pipe.points, graphed, eager


@pytest.mark.card
@pytest.mark.parametrize("refresh,n", [(1, 200), (4, 40)])
def test_graphed_step_matches_eager_bit_for_bit_at_256_mics(card, refresh, n):
    """``n`` blocks at 256 mics from the cold one on: every block's state,
    count and powers equal bit for bit; one graph captured a warm key, the
    rest of the warm blocks replayed, and as many solves counted."""
    points, graphed, eager = _cell_steps(card, refresh)
    blocks = _blocks(n, points, device=card)
    got, want = (graphed.init(), None), (eager.init(), None)
    outs = []
    for block in blocks:
        got, want = graphed(got[0], block), eager(want[0], block)
        outs.append((got, want))
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(outs):
        (gs, gp), (ws, wp) = g, w
        assert gs.count == ws.count == i + 1
        for a, b in zip(_leaves(gs, gp), _leaves(ws, wp)):
            assert torch.equal(a, b), f"block {i}"
    keys = _warm_keys(refresh)
    assert _counts(graphed) == (keys, n - 1 - keys)
    assert graphed.solves == eager.solves == _solves(refresh, n)


@pytest.mark.card
def test_a_replayed_block_makes_no_sync(card):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` a replayed block
    raises nothing."""
    points, step, _ = _cell_steps(card)
    blocks = _blocks(4, points, device=card)
    state = step.init()
    for block in blocks[:3]:
        state, _ = step(state, block)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, powers = step(state, blocks[3])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _counts(step) == (1, 2)
    assert step.solves == 4 and bool(torch.isfinite(powers).all())
