"""The port's own spans (``utils.profiling.span``) in a ``torch.profiler``
trace of ``AwpuPipeline``, on the CPU at 64 mics: which stages open where,
how they nest, and that no profiler event is entered with no profiler
running."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from beamforming_lk_tpu_torch.app import AwpuPipeline  # noqa: E402
from beamforming_lk_tpu_torch.config import Config, realtime  # noqa: E402
from beamforming_lk_tpu_torch.utils import profiling  # noqa: E402

#: Pipeline arguments of each profile the tests drive.
PROFILES = {
    "realtime": (realtime(Config()), {}),
    "default": (Config(), {}),
    "mvdr": (realtime(Config()), {"heatmap_mode": "mvdr"}),
    "music": (realtime(Config()), {"heatmap_mode": "music"}),
}
#: The spans inside the estimator, each once a block.
ESTIMATOR_STAGES = {
    "mvdr": ("awpu.estimator.covariance", "awpu.estimator.factor",
             "awpu.estimator.directions"),
    "music": ("awpu.estimator.covariance", "awpu.estimator.subspace",
              "awpu.estimator.spectrum"),
}


def _pipe(profile_name: str) -> AwpuPipeline:
    cfg, kw = PROFILES[profile_name]
    return AwpuPipeline(cfg, device="cpu", **kw)


def _blocks(pipe, n: int):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((n, pipe.points.shape[1],
                                 pipe.cfg.dsp.block_size)) * 0.01).astype(np.float32)


def _profiled(fn):
    """The program's spans [(name, start_us, end_us)] of ``fn()`` under a
    CPU profiler, in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith(("awpu.", "control."))),
                  key=lambda s: s[1])


def _inside(spans, outer):
    """Names of the spans that lie within span ``outer``."""
    return [s[0] for s in spans if s is not outer
            and outer[1] <= s[1] and s[2] <= outer[2]]


def _calls(spans):
    return [s for s in spans if s[0] == "awpu.call"]


def test_live_block_opens_its_stages_and_the_heatmap_on_its_cadence():
    pipe = _pipe("realtime")
    every = pipe.cfg.mimo.heatmap_every
    assert every == 3
    blocks = _blocks(pipe, every)
    spans = _profiled(lambda: [pipe.process_block(b) for b in blocks])
    calls = _calls(spans)
    assert len(calls) == every
    for k, call in enumerate(calls):
        inner = _inside(spans, call)
        for name in ("awpu.intake", "awpu.ring", "awpu.swarm",
                     "awpu.swarm.prep", "awpu.swarm.draws", "awpu.swarm.run"):
            assert inner.count(name) == 1, (k, name, inner)
        assert inner.count("awpu.heatmap") == (1 if k % every == 0 else 0)
        assert "awpu.call" not in inner and "awpu.miso" not in inner
    # Every span of the program lies in a call.
    assert sum(len(_inside(spans, c)) + 1 for c in calls) == len(spans)


def test_replay_opens_one_swarm_a_chunk():
    pipe = _pipe("realtime")
    m = pipe.step.chunk
    assert m == 12 and pipe.step.takes_chunks(pipe.state, m)
    spans = _profiled(lambda: pipe.process_blocks(_blocks(pipe, m)))
    (call,) = _calls(spans)
    inner = _inside(spans, call)
    for name, n in (("awpu.intake", 1), ("awpu.swarm", 1), ("awpu.swarm.prep", 1),
                    ("awpu.swarm.draws", 1), ("awpu.swarm.run", 1),
                    ("awpu.heatmap", 1),
                    ("awpu.ring", 2),           # the replay's cat, the chunk's windows
                    ("awpu.outputs", 2)):       # the stack, the last block's outputs
        assert inner.count(name) == n, (name, inner)
    assert len(inner) + 1 == len(spans)


def test_default_profile_opens_swarm_and_miso_apart():
    pipe = _pipe("default")
    b = _blocks(pipe, 1)
    spans = _profiled(lambda: pipe.process_block(b[0]))
    (call,) = _calls(spans)
    inner = _inside(spans, call)
    for name in ("awpu.intake", "awpu.ring", "awpu.heatmap", "awpu.swarm",
                 "awpu.swarm.run", "awpu.miso"):
        assert inner.count(name) == 1, (name, inner)
    (swarm,) = (s for s in spans if s[0] == "awpu.swarm")
    (miso,) = (s for s in spans if s[0] == "awpu.miso")
    assert swarm[2] <= miso[1]                     # the listener after the swarm


def test_estimator_opens_in_the_call():
    pipe = _pipe("mvdr")
    b = _blocks(pipe, 1)
    spans = _profiled(lambda: pipe.process_block(b[0]))
    (call,) = _calls(spans)
    inner = _inside(spans, call)
    assert inner.count("awpu.estimator") == 1
    assert "awpu.heatmap" not in inner                  # the DAS map is off


@pytest.mark.parametrize("profile_name", sorted(ESTIMATOR_STAGES))
def test_estimator_opens_its_stages_inside_its_span(profile_name):
    pipe = _pipe(profile_name)
    blocks = _blocks(pipe, 2)
    spans = _profiled(lambda: [pipe.process_block(b) for b in blocks])
    estimators = [s for s in spans if s[0] == "awpu.estimator"]
    assert len(estimators) == 2
    for outer in estimators:
        inner = _inside(spans, outer)
        assert sorted(inner) == sorted(ESTIMATOR_STAGES[profile_name]), inner
    stages = [s for s in spans if s[0].startswith("awpu.estimator.")]
    assert len(stages) == 2 * len(ESTIMATOR_STAGES[profile_name])


@pytest.mark.parametrize("profile_name", sorted(PROFILES))
def test_no_span_is_entered_without_a_profiler(monkeypatch, profile_name):
    pipe = _pipe(profile_name)
    b = _blocks(pipe, 1)[0]

    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_record", refuse)
    out = pipe.process_block(b)
    assert np.isfinite(out.miso_beam.numpy()).all()
    with profiling.StageTimer().stage("step"):
        pass


def test_span_is_one_shared_no_op_without_a_profiler():
    assert profiling.span("awpu.ring") is profiling.span("awpu.swarm")
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("awpu.ring") is not profiling.span("awpu.ring")
    assert profiling.span("awpu.ring") is profiling.span("awpu.call")


def test_spans_keep_the_outputs():
    """A profiled pipeline gives the unprofiled one's outputs bit for bit."""
    cfg, _ = PROFILES["realtime"]
    a, b = (AwpuPipeline(cfg, seed=5, device="cpu") for _ in range(2))
    blocks = _blocks(a, 2)
    plain = [a.process_block(x) for x in blocks]
    with profile(activities=[ProfilerActivity.CPU]):
        traced = [b.process_block(x) for x in blocks]
    for p, t in zip(plain, traced):
        torch.testing.assert_close(t.miso_beam, p.miso_beam, rtol=0, atol=0)
        torch.testing.assert_close(t.targets.theta, p.targets.theta, rtol=0, atol=0)
        torch.testing.assert_close(t.powers, p.powers, rtol=0, atol=0)
