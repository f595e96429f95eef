"""Wideband MUSIC's subspace step replayed as a CUDA graph
(``models/music.py::MusicStep.forward``, ``utils/graphs.py``):

- on the CPU: that the CPU, the ``eigh`` solver and a bin-sharded step
  stay eager (nothing captured, nothing replayed); and, with a recorded
  stand-in for the graph (``test_torch_swarm_graph._Recorded``), that the
  replayed step equals the eager one bit for bit over a cold block and
  warm ones, that ``qr_rounds`` counts 8 + 2 n through replays, and that a
  call's state and spectrum are not overwritten by the next call;
- on the card (marked ``card``, skipped without one): the graphed step at
  256 mics in the ``lk256-music`` configuration against the eager one, bit
  for bit over 200 blocks from the cold one on, and a replayed block that
  makes no sync.

The card tests import no JAX: run them on the card with
``python -m pytest tests/test_torch_music_graph.py -q -m card --noconftest``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from beamforming_lk_tpu_torch.app import AwpuPipeline  # noqa: E402
from beamforming_lk_tpu_torch.config import ArrayConfig, Config, MimoConfig, realtime  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models import music as mu  # noqa: E402
from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from tests.test_torch_swarm_graph import (  # noqa: E402, F401
    _Recorded, _leaves, _recorded_capture, card, world1,
)

ACFG = ArrayConfig()
POINTS = ant.create_antenna_grid(8, 8, 0.02)
SOURCES = [(0.5, 1.2, 5000.0), (0.8, 2.0, 3000.0)]


def _step(solver="subspace", points=POINTS, grid=8, device="cpu"):
    theta, phi = make_mimo_grid(MimoConfig(rows=grid, columns=grid))
    step, _ = mu.make_music_step(points, theta, phi, ACFG, solver=solver,
                                 device=device)
    return step


def _blocks(n: int, points=POINTS, device="cpu"):
    rng = np.random.default_rng(3)
    return [torch.as_tensor(plane_wave_block(
        points, SOURCES, i * 256, 256, ACFG, noise_std=0.02, rng=rng),
        device=device) for i in range(n)]


def _counts(step):
    g = step.graphs
    return (0, 0) if g is None else (g.captures, g.replays)


def _equal(got, want):
    """Two ``(MusicState, pseudo)`` pairs equal bit for bit, count and all."""
    (gs, gp), (ws, wp) = got, want
    assert gs.count == ws.count
    for a, b in zip(_leaves(gs, gp), _leaves(ws, wp)):
        assert torch.equal(a, b)


@pytest.fixture
def recorded(monkeypatch):
    """A CUDA graph stood in by :class:`_Recorded` on the CPU."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Recorded)
    monkeypatch.setattr(torch.cuda, "graph", _recorded_capture)


@pytest.mark.parametrize("case,graphed", [("subspace", True), ("eigh", False),
                                          ("shard", False)])
def test_the_cpu_eigh_and_a_shard_stay_eager(request, case, graphed):
    """The subspace step gets its graphs, ``eigh`` and a bin-sharded step
    none; on the CPU every block runs eagerly: nothing captured, nothing
    replayed, and the rounds counted as the eager step counts them."""
    if case == "shard":
        from beamforming_lk_tpu_torch.parallel import make_mesh

        request.getfixturevalue("world1")
        mesh = make_mesh((1,), axis_names=("dir",), device_type="cpu")
        theta, phi = make_mimo_grid(MimoConfig(rows=8, columns=8))
        step, state = mu.make_sharded_music_step(POINTS, theta, phi, mesh,
                                                 array_cfg=ACFG, device="cpu")
    else:
        step = _step(case)
        state = step.init()
    assert (step.graphs is not None) == graphed
    for block in _blocks(4):
        state, _ = step(state, block)
    assert _counts(step) == (0, 0)
    assert state.count == 4
    assert step.qr_rounds == (0 if case == "eigh" else 8 + 3 * 2)


def test_a_recorded_replay_equals_the_eager_step(recorded):
    """With :class:`_Recorded` in place of a CUDA graph, a cold block and 8
    warm ones through ``MusicStep._replay`` against the eager step from one
    state: state, count and spectrum equal bit for bit every block; the
    cold block and the first warm one run eagerly, the second warm one
    captures, and it and the 6 after it replay."""
    eager, graphed = _step(), _step()
    want = got = (eager.init(), None)
    for block in _blocks(9):
        want = eager._step(want[0], block)
        got = graphed._replay(got[0], block)
        _equal(got, want)
    assert _counts(graphed) == (1, 7)


def test_qr_rounds_count_on_through_replays(recorded):
    """``qr_rounds`` reads 8 after the cold block and 2 more after every
    warm one, replayed or not."""
    step, n = _step(), 7
    state = step.init()
    seen = []
    for block in _blocks(1 + n):
        state, _ = step._replay(state, block)
        seen.append(step.qr_rounds)
    assert seen == [8 + 2 * i for i in range(1 + n)]
    assert _counts(step) == (1, n - 1)


def test_a_replay_leaves_earlier_results_alone(recorded):
    """The state and spectrum a call returned read the same after every
    later call, replays included."""
    step = _step()
    state, held = step.init(), []
    for block in _blocks(7):
        state, pseudo = step._replay(state, block)
        for tensors, copies in held:
            assert all(torch.equal(a, b) for a, b in zip(tensors, copies))
        held.append((_leaves(state, pseudo), [x.clone() for x in _leaves(state, pseudo)]))
    assert _counts(step)[1] == 5


def _cell_steps(device):
    """The ``lk256-music`` estimator (``realtime(Config())`` at 256 mics,
    MUSIC's subspace solver, K = 3) as the pipeline builds it, and a twin
    with its graphs taken away."""
    pipe = AwpuPipeline(realtime(Config()), channels=256, heatmap_mode="music",
                        device=device)
    graphed = pipe._mvdr_step
    theta, phi = make_mimo_grid(pipe.cfg.mimo)
    eager, _ = mu.make_music_step(pipe.points, theta, phi, pipe.cfg.array,
                                  n_sources=3, device=device)
    eager.graphs = None
    return pipe.points, graphed, eager


@pytest.mark.card
def test_graphed_step_matches_eager_bit_for_bit_at_256_mics(card):
    """200 blocks at 256 mics from the cold one on: every block's state,
    count and spectrum equal bit for bit; one graph captured, 198 replays,
    and as many rounds counted."""
    points, graphed, eager = _cell_steps(card)
    blocks = _blocks(200, points, device=card)
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
    assert _counts(graphed) == (1, 198)
    assert graphed.qr_rounds == eager.qr_rounds == 8 + 2 * 199


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
        state, pseudo = step(state, blocks[3])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _counts(step) == (1, 2)
    assert bool(torch.isfinite(pseudo).all())
