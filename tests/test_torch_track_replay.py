"""The port's track replay (``beamforming_lk_tpu_torch/tools/track_replay.py``)
against the JAX package's tool (``tools/track_replay.py``, loaded by path)
on the CPU, on ray logs that the port's ``TargetFusion(log_path=...)``
writes: the jittered steps of
``tests/test_torch_fusion.py::test_ray_log_round_trip`` over 60 steps, the
same steps stamped in epoch nanoseconds, two targets 3 m apart with a gap
past the track timeout, and a log with malformed lines.

Both tools triangulate in f32 (JAX and torch round apart by an ulp here and
there), so positions are held within 1e-5 m and everything else exactly.
"""

import contextlib
import importlib.util
import io
import os
import random
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from beamforming_lk_tpu_torch import config as tcfg  # noqa: E402
from beamforming_lk_tpu_torch.models.fusion import TargetFusion  # noqa: E402
from beamforming_lk_tpu_torch.tools import track_replay as tr  # noqa: E402
from tests.test_torch_fusion import ARRAYS, TARGET, _spherical_of  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 60
EPOCH_NS = 1_700_000_000_000_000_000

# Lines the JAX tool skips, and lines it keeps although numpy warns on them.
MALFORMED = [
    "",
    "-1 0 0,0 0 1;1 0 0,0 0 1",                    # two fields
    "-1 0 0,0 0 1;1 0 0,0 0 1;0.1;extra",          # four fields
    "-1 0 0;1 0 0,0 0 1;0.1",                      # one vector in a pair
    "-1 0 0,0 0 1,2 2 2;1 0 0,0 0 1;0.1",          # three vectors in a pair
    "-1 0,0 0 1;1 0 0,0 0 1;0.1",                  # 2 long
    "-1 0 0 4,0 0 1;1 0 0,0 0 1;0.1",              # 4 long
    "a b c,0 0 1;1 0 0,0 0 1;0.1",                 # no number
    "-1 0 0,0 0 1;1 0 0, ;0.1",                    # whitespace alone
    "-1 0 0,0 0 1;1 0 0,0 0 1;t=0.1",              # timestamp
    "-1 0 0,0.1 0 1;1 0 0,-0.1 0 1x;0.2",          # trailing text: kept
    " -1 0 0 ,0.1  0\t1;1e0 0 0,-1e-1 0 1;0.3",    # spacing, exponents: kept
    "-1 0 0,0.1 0 1;1 0 0,-0.1 0 1;0.4",           # kept
    "-1 0 0,nan 0 1;1 0 0,-0.1 0 1;0.5",           # nan: kept, invalid
]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_track_replay", os.path.join(REPO, "tools", "track_replay.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_log(path, targets, times, seed=5):
    """The port's fusion logging every cross pair of two arrays that each
    see ``targets``, theta jittered as in the round-trip test."""
    rng = np.random.default_rng(seed)
    fusion = TargetFusion(tcfg.TriangulationConfig(), log_path=path, device="cpu")
    for pos in ARRAYS:
        fusion.add_array(None, pos)
    for k, now in enumerate(times):
        fusion.step(now=now, target_lists=[
            [_spherical_of(origin, target, sign * 1e-4 * k + rng.normal(0.0, 1e-3))
             for target in targets]
            for origin, sign in zip(ARRAYS, (1, -1))])
    fusion.close()


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("logs")
    paths = {name: str(d / f"{name}.txt") for name in
             ("jittered", "epoch_ns", "two_targets", "malformed")}
    steps = [0.01 * k for k in range(STEPS)]
    _write_log(paths["jittered"], [TARGET], steps)
    _write_log(paths["epoch_ns"], [TARGET], [EPOCH_NS + 5_000_000 * k
                                             for k in range(STEPS)])
    _write_log(paths["two_targets"], [TARGET, TARGET + np.array([3.0, 0.0, 0.0])],
               steps[:30] + [1.0 + t for t in steps[:30]], seed=6)
    with open(paths["malformed"], "w") as f:
        f.write("\n".join(MALFORMED) + "\n")
    return paths


@pytest.fixture(scope="module")
def jax_tool():
    return _jax_tool()


def _jax_replay(jax_tool, path):
    """The JAX tool's (store, hits) and its printed lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        store, hits = jax_tool.replay(path)
    return store, hits, out.getvalue()


def _best_index(store):
    return next((i for i, t in enumerate(store.tracks) if t is store.best), None)


@pytest.mark.parametrize("name", ["jittered", "epoch_ns", "two_targets", "malformed"])
def test_replay_matches_the_jax_tool(logs, jax_tool, name):
    """Ray pairs and valid intersections, tracks with their hits and flags,
    positions within 1e-5 m, the best track and the printed summary."""
    jstore, jhits, jprinted = _jax_replay(jax_tool, logs[name])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        n_pairs = len(list(jax_tool.parse_log(logs[name])))
        got = tr.replay(logs[name], device="cpu")
    assert len(got.valid) == n_pairs and n_pairs > 0
    assert int(got.valid.sum()) == len(jhits) > 0
    np.testing.assert_allclose(got.hits, np.stack(jhits), rtol=0, atol=1e-5)
    assert len(got.store.tracks) == len(jstore.tracks) > 0
    for mine, theirs in zip(got.store.tracks, jstore.tracks):
        assert (mine.hits, mine.valid) == (theirs.hits, theirs.valid)
        np.testing.assert_allclose(mine.position, theirs.position, rtol=0, atol=1e-5)
    assert _best_index(got.store) == _best_index(jstore) is not None
    assert out.getvalue() == jprinted
    if name == "two_targets":
        assert len(got.store.tracks) >= 2 and not got.valid.all()
    if name == "epoch_ns":
        assert got.times[-1] == pytest.approx(5e-3 * (STEPS - 1))


def test_parse_log_skips_what_the_jax_tool_skips(logs, jax_tool):
    """The malformed log parses to the same rays in both tools: the kept
    lines are the four at the end."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = list(jax_tool.parse_log(logs["malformed"]))
    got = list(tr.parse_log(logs["malformed"]))
    assert [r[4] for r in got] == [r[4] for r in want] == [0.2, 0.3, 0.4, 0.5]
    for mine, theirs in zip(got, want):
        for a, b in zip(mine[:4], theirs[:4]):
            np.testing.assert_array_equal(a, b)


def test_parse_vector_reads_as_numpy_fromstring():
    """``parse_vector`` gives what ``np.fromstring(text, sep=" ")`` gives,
    values and length, on hand-picked edge cases and 20 000 seeded random
    strings of digits, signs, exponents, spaces and letters."""
    cases = ["1 2 3", "1 2 3 x", "1 2 3x", "1.5abc 2", "", " ", "\t", " y",
             "  1   2\t3  ", "1,2", "nan inf -inf", "1e3 1E-2 +4", "1_0 2 3",
             "0x10 1 2", "infinity 1 2", "infinit 1 2", ".5 5. -.5", "1-2 3",
             "--1 2 3", "1e 2 3", "1e+ 2 3", "1.2.3 4 5", "NaN INF 1",
             "nan(123) 1 2", "1e5000 1 2", "-0 1 2", "1\x002 3", "１ 2 3"]
    rng = random.Random(0)
    alphabet = list("0123456789" * 2 + ".eE+-naifxNAI()_,") + [" "] * 4 + ["\t"]
    cases += ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 14)))
              for _ in range(20_000)]
    for text in cases:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            want = np.fromstring(text, sep=" ")
        got = tr.parse_vector(text)
        assert got.shape == want.shape and np.array_equal(got, want, equal_nan=True), text


def test_command_line_prints_the_jax_tools_summary_without_jax(logs, jax_tool):
    """``python -m beamforming_lk_tpu_torch.tools.track_replay LOG --device
    cpu`` exits 0, prints the JAX tool's lines and imports no JAX module
    (``-X importtime`` lists every import)."""
    _, _, jprinted = _jax_replay(jax_tool, logs["two_targets"])
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "beamforming_lk_tpu_torch.tools.track_replay", logs["two_targets"],
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout == jprinted
    imported = [line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    assert "beamforming_lk_tpu_torch.models.fusion" in imported
    assert not [m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "beamforming_lk_tpu")]


def test_command_line_needs_cuda_unless_asked_for_the_cpu(logs, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.main([logs["jittered"]])
    assert tr.main([logs["jittered"], "--device", "cpu"]) == 0
    assert "best:" in capsys.readouterr().out


def test_plot_writes_a_png(logs, tmp_path, capsys):
    """``--plot`` (matplotlib, imported only when asked) writes the hits
    and the alive tracks."""
    png = tmp_path / "hits.png"
    assert tr.main([logs["two_targets"], "--device", "cpu", "--plot", str(png)]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert f"plot -> {png}" in capsys.readouterr().out
