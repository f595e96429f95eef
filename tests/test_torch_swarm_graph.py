"""The swarm stage replayed as a CUDA graph (``utils/graphs.py``): the
default profile's tracker and MISO steps (``models.miso.UnfusedSwarmStep``)
and the realtime profile's fused step (``models.tracker.FusedSwarmStep``,
its K1 launch reading the block's stamp on the card):

- on the CPU: which steps the gate builds the graphs for, that the CPU,
  ``draws=`` and a mesh with a ``ch`` axis stay eager (nothing captured,
  nothing replayed), that the XLA chain and K1's twin stamp a promoted
  tracker's start from the block index's f32 device scalar exactly as
  ``float(block_index)`` did, and, with a recorded stand-in for the graph,
  that a replayed step equals the eager one bit for bit;
- on the card (marked ``card``, skipped without one): the graphed pipeline
  against the eager one at 64 mics, ``Config()``, and in the realtime
  profile at 64 and 256 mics, bit for bit over 300 blocks that cross the
  seeker resets at blocks 0, 128 and 256; that the state and outputs a
  call returned are not overwritten by the next; and that a replayed fused
  block makes no sync.

The card tests import no JAX: run them on the card with
``python -m pytest tests/test_torch_swarm_graph.py -q -m card --noconftest``.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from beamforming_lk_tpu_torch.app import AwpuPipeline  # noqa: E402
from beamforming_lk_tpu_torch.config import (  # noqa: E402
    Config, MimoConfig, TrackerConfig, realtime,
)
from beamforming_lk_tpu_torch.device import f32_mode, full_f32  # noqa: E402
from beamforming_lk_tpu_torch.io import ring as rg  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models import tracker as tk  # noqa: E402
from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk  # noqa: E402

SRC = (0.5, 1.2, 5000.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _small(**tracker):
    """``Config()`` on an 8x8 heatmap (the CPU's size), tracker fields
    replaced by ``tracker``."""
    return Config(mimo=MimoConfig(rows=8, columns=8),
                  tracker=dataclasses.replace(TrackerConfig(), **tracker))


def _blocks(pipe, n: int, start: int = 0, device="cpu"):
    rng = np.random.default_rng(5)
    return [torch.as_tensor(plane_wave_block(
        pipe.points, [SRC], (start + i) * 256, 256, noise_std=0.02, rng=rng),
        device=device) for i in range(n)]


def _graphs(pipe):
    """The graphs of the pipeline's swarm stage: its unfused step's or its
    fused step's (None without one)."""
    step = pipe.step.unfused_step or pipe.step.swarm_step
    return None if step is None else step.graphs


def _counts(pipe):
    g = _graphs(pipe)
    return (0, 0) if g is None else (g.captures, g.replays)


@pytest.mark.parametrize("case,graphed", [
    ("default", True),
    ("realtime_fused", True),
    ("kernel_backend", False),
    ("tracker_only", False),
    ("miso_only", False),
    ("realtime_xla", False),
    ("realtime_chunk", False),
])
def test_the_gate_builds_graphs_for_the_unfused_xla_steps(case, graphed):
    """Graphs for the unfused tracker and MISO steps on the XLA chain
    (``Config()``) and for the fused realtime step on K1; none for the
    swarm-chain kernel's unfused step, a pipeline without the tracker or
    the MISO, the fused step on the XLA chain, or the replay's chunk step
    (one K2 launch a chunk)."""
    rt = realtime(_small())
    cfg, kw = {
        "default": (_small(), {}),
        "realtime_fused": (rt, {}),
        "kernel_backend": (_small(probe_kernel="pallas"), {}),
        "tracker_only": (_small(), dict(enable_miso=False)),
        "miso_only": (_small(), dict(enable_tracker=False)),
        "realtime_xla": (dataclasses.replace(
            rt, tracker=dataclasses.replace(rt.tracker, probe_kernel="xla")), {}),
        "realtime_chunk": (rt, {}),
    }[case]
    pipe = AwpuPipeline(cfg, device="cpu", **kw)
    if case == "realtime_chunk":
        assert pipe.step.chunk_step is not None
        assert (pipe.step.chunk_step.graphs is not None) == graphed
    else:
        assert (_graphs(pipe) is not None) == graphed


@pytest.mark.parametrize(
    "realtime_profile,with_draws",
    [(False, False), (False, True), (True, False), (True, True)],
    ids=["own_draws", "draws", "realtime_own_draws", "realtime_draws"])
def test_the_cpu_and_draws_stay_eager(realtime_profile, with_draws):
    """On the CPU, with the pipeline's own draws or with ``draws=``, in the
    default and the realtime profile, nothing is captured or replayed and
    no K0 or K1 launch is counted."""
    pipe = AwpuPipeline(realtime(_small()) if realtime_profile else _small(),
                        device="cpu")
    tc = pipe.cfg.tracker
    rng = np.random.default_rng(1)
    launches = ctk.monopulse_chain.launches, ctk.swarm_chain.launches
    for block in _blocks(pipe, 3):
        draws = None
        if with_draws:
            draws = (rng.uniform(0, tc.theta_limit, tc.n_seekers),
                     rng.uniform(0, 2 * np.pi, tc.n_seekers),
                     *rng.uniform(-1, 1, (2, tc.iterations, tc.n_seekers)))
        pipe.process_block(block, draws=draws)
    assert _graphs(pipe) is not None
    assert _counts(pipe) == (0, 0)
    assert (ctk.monopulse_chain.launches, ctk.swarm_chain.launches) == launches


@pytest.fixture
def world1(tmp_path):
    """A one-process gloo group, torn down after the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("realtime_profile,axes,graphed", [
    (False, ("ch", "dir"), False), (False, ("dir",), True),
    (True, ("ch", "dir"), False), (True, ("dir",), True),
], ids=["ch_dir", "dir", "realtime_ch_dir", "realtime_dir"])
def test_a_ch_axis_keeps_the_collectives_eager(world1, realtime_profile, axes,
                                               graphed):
    """A mesh with a ``ch`` axis gets no graphs (its chain and beam reduce
    over ``ch``; the fused step takes the XLA chain there, its reference
    power an all-reduce); a ``dir``-only mesh runs the swarm whole on each
    rank and gets them.  Blocks run eagerly on the CPU either way."""
    from beamforming_lk_tpu_torch.parallel import make_mesh

    mesh = make_mesh((1,) * len(axes), axis_names=axes, device_type="cpu")
    pipe = AwpuPipeline(realtime(_small()) if realtime_profile else _small(),
                        mesh=mesh, device="cpu")
    assert (_graphs(pipe) is not None) == graphed
    for block in _blocks(pipe, 2):
        pipe.process_block(block)
    assert _counts(pipe) == (0, 0)


def _check_stamps(pipe, first: int):
    """From block ``first`` on, each tracker promoted in block b is stamped
    ``float(b)`` rounded to f32, and some stamp is rounded."""
    pipe.state = pipe.state._replace(block_index=first)
    stamped = []
    for b, block in enumerate(_blocks(pipe, 8), start=first):
        before = pipe.state.swarm.start.clone()
        pipe.process_block(block)
        start = pipe.state.swarm.start
        new = start != before
        assert torch.equal(start[new], torch.full_like(start[new], np.float32(float(b))))
        stamped += [b] * int(new.sum())
    assert any(float(np.float32(b)) != b for b in stamped), "no rounded stamp"


def _window(pipe):
    dsp = pipe.cfg.dsp
    return rg.ring_window(pipe.state.history, dsp.block_size, dsp.shift_range,
                          pipe.step.taps)


def _same_leaves(got, want):
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_the_device_stamp_promotes_as_the_host_index_did():
    """From block 2**24 - 3 on, where f32 no longer holds every index, each
    tracker promoted in block b is stamped ``float(b)`` rounded to f32 (the
    value the host index gave), and a step given the stamp as a tensor
    gives what the host index gives."""
    pipe = AwpuPipeline(_small(), device="cpu")
    first = 2 ** 24 - 3
    _check_stamps(pipe, first)
    step, window = pipe.step.unfused_step.tracker, _window(pipe)
    by_int = step(pipe.state.swarm, window, first + 4,
                  generator=torch.Generator().manual_seed(3))
    by_stamp = step(pipe.state.swarm, window, tk.block_stamp(first + 4, window),
                    generator=torch.Generator().manual_seed(3))
    _same_leaves(by_int, by_stamp)


def test_k1_takes_the_stamp_as_the_host_index():
    """The realtime profile's fused step (K1's twin on the CPU): from block
    2**24 - 3 on, promoted trackers are stamped ``float(b)`` rounded to
    f32; the step, and K1's twin alone, given the block's stamp as a
    tensor give what the host index gives."""
    pipe = AwpuPipeline(realtime(_small()), device="cpu", seed=1)
    first = 2 ** 24 - 3
    _check_stamps(pipe, first)
    step, window = pipe.step.swarm_step, _window(pipe)
    miso = pipe.state.miso.particle
    by_int, by_stamp = (
        step(pipe.state.swarm, miso, window, index,
             generator=torch.Generator().manual_seed(3))
        for index in (first + 8, tk.block_stamp(first + 8, window)))
    _same_leaves(by_int, by_stamp)

    reference, win_bp, pw = step._prep(window)
    seekers, jumps = step._draw(pipe.state.swarm, window.device,
                                torch.Generator().manual_seed(3), None)
    ops = (step.probes.xyz, win_bp, pw, step._rows(pipe.state.swarm, miso, seekers),
           jumps, reference)
    # Every tracker slot free, so a converged seeker is promoted and the
    # stamp written (asserted below).
    rows = ops[3].clone()
    rows[6] = 0.0
    ops = ops[:3] + (rows,) + ops[4:]
    kw = step._kernel_kw()
    by_int = ctk.swarm_chain(*ops, block_index=first + 8, **kw)
    by_stamp = ctk.swarm_chain(*ops, block_index=tk.block_stamp(first + 8, window),
                               **kw)
    _same_leaves(by_int, by_stamp)
    assert (by_int[0][7] == float(np.float32(first + 8))).any(), "nothing promoted"


def _leaves(*trees):
    return [x for x in torch.utils._pytree.tree_leaves(trees)
            if isinstance(x, torch.Tensor)]


class _Recorded:
    """A CPU stand-in for ``torch.cuda.CUDAGraph``: the capture records
    every op the step dispatches and a replay runs them again in order,
    each writing into the tensors it gave at the capture.  So, as on the
    card, a replay reads only the static operands and the registered
    generators, and a host value read at the capture stays baked in."""

    def __init__(self):
        self.ops, self.generators = [], []

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        for func, args, kwargs, out in self.ops:
            got = func(*args, **kwargs)
            for o, g in zip(_leaves(out), _leaves(got)):
                if o.untyped_storage().data_ptr() != g.untyped_storage().data_ptr():
                    o.copy_(g)


class _Recorder(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((func, args, kwargs or {}, out))
        return out


@contextlib.contextmanager
def _recorded_capture(graph, **_):
    """``torch.cuda.graph`` for :class:`_Recorded`: the step runs once,
    recorded, and its generators are set back, since a capture draws
    nothing."""
    saved = [g.get_state() for g in graph.generators]
    with _Recorder(graph.ops):
        yield
    for g, state in zip(graph.generators, saved):
        g.set_state(state)


def test_a_recorded_replay_equals_the_eager_steps(monkeypatch):
    """On the CPU with :class:`_Recorded` in place of a CUDA graph, 12
    blocks with a seeker reset every 5th through
    ``UnfusedSwarmStep._replay`` against the eager tracker and MISO steps,
    from one state and seed:
    states, targets, beams and generators equal bit for bit every block;
    2 graphs captured (blocks 2 and 5), 10 replays; each call's results
    read the same after the next call; other TF32 switches key their own
    graph."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Recorded)
    monkeypatch.setattr(torch.cuda, "graph", _recorded_capture)
    mode = f32_mode()
    cfg = _small(seeker_reset_interval=5)
    pipe = AwpuPipeline(cfg, device="cpu", seed=4)
    step, dsp = pipe.step.unfused_step, cfg.dsp
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    eager = graphed = pipe.state
    history, held = pipe.state.history, []
    for block in _blocks(pipe, 12):
        history = rg.ring_push(history, block)
        window = rg.ring_window(history, dsp.block_size, dsp.shift_range,
                                pipe.step.taps)
        want = step._both(eager.swarm, eager.miso, window, eager.block_index,
                          gens[0])
        got = step._replay(graphed.swarm, graphed.miso, window,
                           graphed.block_index, gens[1])
        for a, b in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
        for tensors, copies in held:
            assert all(torch.equal(a, b) for a, b in zip(tensors, copies))
        held.append((_leaves(got), [x.clone() for x in _leaves(got)]))
        eager, graphed = (s._replace(swarm=r[0], miso=r[2],
                                     block_index=s.block_index + 1)
                          for s, r in ((eager, want), (graphed, got)))
    assert _counts(pipe) == (2, 10)
    # Other TF32 switches are another key: a first use, then a capture.
    with full_f32():
        assert f32_mode() != mode
        for _ in range(2):
            step._replay(graphed.swarm, graphed.miso, window,
                         graphed.block_index, gens[1])
    assert _counts(pipe) == (3, 11)


def test_a_recorded_replay_equals_the_eager_fused_step(monkeypatch):
    """On the CPU with :class:`_Recorded` in place of a CUDA graph, 260
    blocks of the realtime profile's fused step from block 2**24 - 3 (so
    the stamps round) through ``FusedSwarmStep._replay`` against its eager
    ``_step``, from one state and seed, crossing the seeker resets at
    blocks 128 and 256: states, targets, listeners, beams and generators
    equal bit for bit every block; trackers promoted in the window carry
    the rounded stamps; 2 graphs captured (blocks 2 and 128), 258 replays;
    the host counter counts on; no call's results are overwritten."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Recorded)
    monkeypatch.setattr(torch.cuda, "graph", _recorded_capture)
    n, first = 260, 2 ** 24 - 3
    pipe = AwpuPipeline(realtime(_small()), device="cpu", seed=4)
    step, dsp = pipe.step.swarm_step, pipe.cfg.dsp
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    eager = graphed = (pipe.state.swarm, pipe.state.miso.particle)
    history, held, starts = pipe.state.history, [], set()
    for b, block in enumerate(_blocks(pipe, n)):
        history = rg.ring_push(history, block)
        window = rg.ring_window(history, dsp.block_size, dsp.shift_range,
                                pipe.step.taps)
        want = step._step(*eager, window, first + b, gens[0])
        got = step._replay(*graphed, window, first + b, gens[1])
        _same_leaves(got, want)
        assert torch.equal(gens[0].get_state(), gens[1].get_state())
        assert got[0].reset_count == b + 1
        starts.update(got[1].start[got[1].valid].tolist())
        held.append((_leaves(got), [x.clone() for x in _leaves(got)]))
        eager, graphed = (want[0], want[2]), (got[0], got[2])
    assert _counts(pipe) == (2, n - 2)
    for tensors, copies in held:
        assert all(torch.equal(a, b) for a, b in zip(tensors, copies))
    # Promoted in more than one block, each at its own block's stamp: not
    # one stamp frozen at a capture.
    assert 1 < len(starts)
    assert starts <= {float(np.float32(first + b)) for b in range(n)}


@pytest.mark.card
def test_graphed_pipeline_matches_eager_bit_for_bit(card):
    """300 blocks of ``Config()`` at 64 mics from one seed, the graphed
    pipeline against one with its graphs taken away: every block's
    outputs, the last state and the generator's state equal bit for bit;
    two graphs captured (no reset and reset), 298 replays, and as many K0
    launches counted as the eager pipeline made."""
    pipes = [AwpuPipeline(Config(), channels=64, seed=2_718_281_828, device=card)
             for _ in range(2)]
    pipes[1].step.unfused_step.graphs = None
    blocks = _blocks(pipes[0], 300, device=card)
    launches = []
    for pipe in pipes:
        n0 = ctk.monopulse_chain.launches
        outs = [_leaves(pipe.process_block(b)) for b in blocks]
        torch.cuda.synchronize()
        launches.append(ctk.monopulse_chain.launches - n0)
        pipe.outs = outs
    for i, (got, want) in enumerate(zip(pipes[0].outs, pipes[1].outs)):
        for a, b in zip(got, want):
            assert torch.equal(a, b), f"block {i}"
    for a, b in zip(_leaves(pipes[0].state), _leaves(pipes[1].state)):
        assert torch.equal(a, b)
    assert pipes[0].state.swarm.reset_count == pipes[1].state.swarm.reset_count == 300
    assert torch.equal(pipes[0].generator.get_state(), pipes[1].generator.get_state())
    assert _counts(pipes[0]) == (2, 298)
    assert launches[0] == launches[1] == 11 * 300


@pytest.mark.card
def test_a_call_leaves_earlier_results_alone(card):
    """The state and outputs call k returned read the same after call k+1
    (and after a block with a seeker reset), and ``draws=`` on the card
    runs eagerly."""
    pipe = AwpuPipeline(Config(), channels=64, seed=7, device=card)
    blocks = _blocks(pipe, 132, device=card)
    for b in blocks[:3]:
        pipe.process_block(b)
    held = []
    for b in blocks[3:]:
        out = pipe.process_block(b)
        torch.cuda.synchronize()
        held.append((_leaves(out, pipe.state), [x.clone() for x in _leaves(out, pipe.state)]))
    for tensors, copies in held:
        for a, b in zip(tensors, copies):
            assert torch.equal(a, b)
    assert _counts(pipe)[1] == len(blocks) - 2
    tc = pipe.cfg.tracker
    rng = np.random.default_rng(0)
    draws = (rng.uniform(0, tc.theta_limit, tc.n_seekers),
             rng.uniform(0, 2 * np.pi, tc.n_seekers),
             *rng.uniform(-1, 1, (2, tc.iterations, tc.n_seekers)))
    pipe.process_block(blocks[0], draws=draws)
    assert _counts(pipe)[1] == len(blocks) - 2


@pytest.mark.card
@pytest.mark.parametrize("channels", [64, 256])
def test_graphed_realtime_pipeline_matches_eager_bit_for_bit(card, channels):
    """300 blocks of ``realtime(Config())`` from one seed, the pipeline
    whose fused step replays against one with its graphs taken away: every
    block's outputs, the last state and the generator's state equal bit for
    bit; two graphs captured (no reset and reset), 298 replays, and one K1
    launch counted a block on both."""
    pipes = [AwpuPipeline(realtime(Config()), channels=channels,
                          seed=3_141_592_653, device=card) for _ in range(2)]
    pipes[1].step.swarm_step.graphs = None
    blocks = _blocks(pipes[0], 300, device=card)
    launches = []
    for pipe in pipes:
        n0 = ctk.swarm_chain.launches
        pipe.outs = [_leaves(pipe.process_block(b)) for b in blocks]
        torch.cuda.synchronize()
        launches.append(ctk.swarm_chain.launches - n0)
    for i, (got, want) in enumerate(zip(pipes[0].outs, pipes[1].outs)):
        for a, b in zip(got, want):
            assert torch.equal(a, b), f"block {i}"
    for a, b in zip(_leaves(pipes[0].state), _leaves(pipes[1].state)):
        assert torch.equal(a, b)
    assert pipes[0].state.swarm.reset_count == pipes[1].state.swarm.reset_count == 300
    assert torch.equal(pipes[0].generator.get_state(), pipes[1].generator.get_state())
    assert _counts(pipes[0]) == (2, 298)
    assert launches[0] == launches[1] == 300


@pytest.mark.card
def test_a_replayed_fused_block_makes_no_sync(card):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` a replayed block
    of the realtime fused step raises nothing (called as the pipeline
    calls it, inside ``full_f32``, so that it finds the pipeline's
    graph)."""
    pipe = AwpuPipeline(realtime(Config()), channels=64, seed=7, device=card)
    blocks = _blocks(pipe, 4, device=card)
    for b in blocks[:3]:
        pipe.process_block(b)
    state = pipe.state
    history = rg.ring_push(state.history, blocks[3])
    window = rg.ring_window(history, pipe.cfg.dsp.block_size,
                            pipe.cfg.dsp.shift_range, pipe.step.taps)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with full_f32():
            out = pipe.step.swarm_step(state.swarm, state.miso.particle, window,
                                       state.block_index, generator=pipe.generator)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _counts(pipe) == (1, 2)
    assert bool(torch.isfinite(out[3]).all())
