"""The port's multi-device path (``parallel/``, the sharded AWPU step, the
bin-sharded MVDR and MUSIC) on four spawned CPU ranks against the JAX
package's sharded functions on four of the 8 virtual CPU devices that
``conftest.py`` gives, each with the port's mesh shape.

One gloo process group of four ranks (rendezvous through a ``FileStore``
under the test's temporary directory) runs every case; the ranks import
no JAX and write their outputs to ``.npz`` files, which each test holds
against the JAX outputs.  This file is also the ranks' program:
``python tests/test_torch_parallel.py DIR RANK``.

Bounds are the JAX package's own for its sharded results
(``tests/test_parallel.py``, ``tests/test_awpu.py``,
``tests/test_mvdr.py``, ``tests/test_music.py``): an all-reduce sums the
partial beams in another order than the dense sum.  MVDR against the JAX
package is held at 2e-3, as ``tests/test_torch_mvdr.py`` holds it; MUSIC at
the JAX package's sharded-vs-dense 5e-4 against the port's own dense step,
and by the argmax against the JAX sharded step.
"""

import contextlib
import io
import os
import subprocess
import sys
import traceback
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SRC = (0.5, 2.0, 5000.0)
MANY_MICS = 1024


# ---------------------------------------------------------------- the ranks

def _state_tree(data, prefix):
    """A JAX state saved by ``beamforming_lk_tpu.io.checkpoint.save_state``
    (keys ``.history``, ``.swarm/.seekers/.theta``, ...) as nested
    namespaces of numpy arrays, which ``convert.awpu_state_from_jax``
    reads."""
    root = {}
    for key in data:
        if key.startswith(prefix):
            node = root
            *path, leaf = key[len(prefix):].split("/")
            for part in path:
                node = node.setdefault(part.lstrip("."), {})
            node[leaf.lstrip(".")] = data[key]

    def ns(d):
        return types.SimpleNamespace(
            **{k: ns(v) if isinstance(v, dict) else v for k, v in d.items()})
    return ns(root)


def _draws(inputs, case, i):
    return tuple(inputs[f"{case}/draws{i}/{j}"] for j in range(4))


def _numpy_tree(tree):
    """A port state with numpy leaves, the form ``convert`` reads."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, tuple):
        return type(tree)(*(_numpy_tree(v) for v in tree))
    return tree


def _leaves(tree):
    """The tensors of a port state in tree order (host counters as 0-d
    tensors)."""
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [torch.as_tensor(tree)]


def _awpu_cfg(iterations, backend="dense"):
    from beamforming_lk_tpu_torch import config as tcfg

    return tcfg.Config(mimo=tcfg.MimoConfig(rows=16, columns=16, backend=backend),
                       tracker=tcfg.TrackerConfig(iterations=iterations))


def _rank_cases():
    """Each case: (inputs) -> {name: array}, run on every rank in order."""
    from beamforming_lk_tpu_torch import convert
    from beamforming_lk_tpu_torch.app import AwpuPipeline, awpu_init
    from beamforming_lk_tpu_torch.models import music as mu
    from beamforming_lk_tpu_torch.models import mvdr as mv
    from beamforming_lk_tpu_torch.ops import delay as dl
    from beamforming_lk_tpu_torch.parallel import (
        make_mesh, make_sharded_das_power, make_sharded_mimo_step,
        make_time_sharded_beam, shard_weights, shard_window,
    )
    from beamforming_lk_tpu_torch.parallel import mesh as pm

    t = torch.as_tensor

    def factoring(inp):
        m = make_mesh(device_type="cpu")
        return dict(shape=np.array([m.size(0), m.size(1)]),
                    names=np.array(m.mesh_dim_names),
                    coordinate=np.array(m.get_coordinate()))

    def power(shape):
        def case(inp):
            m = make_mesh(shape, device_type="cpu")
            f = make_sharded_das_power(m, use_bandpass=True)
            return dict(powers=f(shard_window(t(inp["window"]), m),
                                 shard_weights(t(inp["weights"]), m)),
                        coordinate=np.array(m.get_coordinate()))
        return case

    def time_beam(shape, axis_names=(pm.DIR_AXIS, pm.TIME_AXIS)):
        def case(inp):
            m = make_mesh(shape, axis_names=axis_names, device_type="cpu")
            s = inp["weights"].shape[-1]
            window = t(inp["window"])
            block = window[:, s:]
            f = make_time_sharded_beam(m)
            part = pm.Axis(m, pm.TIME_AXIS).part(block.shape[-1])
            weights = shard_weights(t(inp["weights"]), m)
            return dict(beam=f(block[:, part].contiguous(), window[:, :s], weights),
                        dense=dl.das_beam(window, weights)[:, part],
                        own=dl.das_beam(window[:, part.start:part.stop + s], weights),
                        coordinate=np.array(m.get_coordinate()))
        return case

    def streaming(inp):
        m = make_mesh((2, 2), device_type="cpu")
        step = make_sharded_mimo_step(m, block_size=256, shift_range=64, taps=2)
        c = inp["block"].shape[0]
        hist = torch.zeros((c // 2, 1024))
        hist, powers = step(hist, shard_window(t(inp["block"]), m),
                            shard_weights(t(inp["weights"]), m))
        return dict(history=hist, powers=powers,
                    coordinate=np.array(m.get_coordinate()))

    def many_array(inp):
        m = make_mesh((4, 1), device_type="cpu")
        part = pm.Axis(m, pm.CH_AXIS).part(MANY_MICS)
        weights = dl.das_weights_np(inp["many/delays"][:, part], 192)
        f = make_sharded_das_power(m, use_bandpass=True)
        return dict(powers=f(shard_window(t(inp["many/window"]), m), t(weights)))

    def awpu(case, iterations, backend="dense", mask=True, batch=False):
        def drive(inp, mesh, backend):
            """The pipeline on ``mesh`` (or unsharded) from the JAX state,
            fed the case's blocks and draws."""
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                pipe = AwpuPipeline(
                    _awpu_cfg(iterations, backend), points=inp["points"],
                    channel_mask=inp["mask"] if mask else None, mesh=mesh,
                    device="cpu")
            pipe.state = convert.awpu_state_from_jax(
                _state_tree(inp, f"{case}/state0"), "cpu", mesh=mesh)
            blocks = inp[f"{case}/blocks"]
            if batch:
                draws = tuple(np.stack([_draws(inp, case, i)[j]
                                        for i in range(len(blocks))])
                              for j in range(4))
                pipe.process_blocks(blocks, draws=draws)
            else:
                for i, blk in enumerate(blocks):
                    pipe.process_block(blk, draws=_draws(inp, case, i))
            return pipe, err.getvalue()

        def run(inp):
            m = make_mesh((2, 2), device_type="cpu")
            pipe, note = drive(inp, m, backend)
            dense, _ = drive(inp, None, "dense")    # the JAX tests' reference
            out, sw = pipe.last, pipe.state.swarm
            return dict(
                powers=out.powers, miso_beam=out.miso_beam,
                theta=out.targets.theta, phi=out.targets.phi,
                valid=out.targets.valid, history=pipe.state.history,
                swarm=torch.cat([torch.cat(sw.seekers), torch.cat(sw.trackers),
                                 sw.tracking.float(), sw.start]),
                dense_powers=dense.last.powers[pipe.step.layout.dir.part(
                    dense.last.powers.shape[0])],
                dense_beam=dense.last.miso_beam,
                dense_theta=dense.last.targets.theta,
                dense_valid=dense.last.targets.valid,
                coordinate=np.array(m.get_coordinate()), note=np.array(note))
        return run

    def placement(inp):
        """A whole state carried over under a (2, 2) mesh, and the same
        state from ``awpu_init`` under it: each leaf with its device."""
        m = make_mesh((2, 2), device_type="cpu")
        cfg = _awpu_cfg(1)
        whole = awpu_init(cfg, 64, seed=5, device="cpu")
        out = {}
        for name, state in (
                ("converted", convert.awpu_state_from_jax(_numpy_tree(whole),
                                                          "cpu", mesh=m)),
                ("init", awpu_init(cfg, 64, mesh=m, seed=5, device="cpu"))):
            leaves = _leaves(state)
            out.update({f"{name}{i}": v for i, v in enumerate(leaves)})
            out[f"{name}_devices"] = np.array([str(v.device) for v in leaves])
        out["n_leaves"] = np.array(len(leaves))
        return out

    def estimator(kind, **kw):
        def run(inp):
            m = make_mesh((1, 4), device_type="cpu")
            args = (inp["est/points"], inp["est/theta"], inp["est/phi"])
            if kind == "mvdr":
                sharded, state = mv.make_sharded_mvdr_step(*args, m, device="cpu", **kw)
                dense, _ = mv.make_mvdr_step(*args, device="cpu", **kw)
            else:
                sharded, state = mu.make_sharded_music_step(
                    *args, m, n_sources=2, device="cpu", **kw)
                dense, _ = mu.make_music_step(*args, n_sources=2, device="cpu", **kw)
            dstate, got, want = dense.init(), [], []
            for blk in inp["est/blocks"]:
                state, p = sharded(state, t(blk))
                dstate, q = dense(dstate, t(blk))
                got.append(p)
                want.append(q)
            return dict(powers=torch.stack(got), dense=torch.stack(want),
                        bins=np.array(sharded.n_bins))
        return run

    return {
        "factoring": factoring,
        "ch_dir_power": power((2, 2)),
        "dir_power": power((1, 4)),
        "time_beam": time_beam((2, 2)),
        # (dir, t) = (1, 2) on each pair of ranks: two replicas of the
        # shape chip_smoke.py's phase 15c runs on two ranks of one card.
        "time_beam_1x2": time_beam((2, 1, 2), ("replica", pm.DIR_AXIS, pm.TIME_AXIS)),
        "streaming": streaming,
        "many_array": many_array,
        "fused": awpu("fused", 2),
        "scan": awpu("scan", 1, mask=False, batch=True),
        "fft": awpu("fft", 2, backend="fft", mask=False),
        "placement": placement,
        "mvdr": estimator("mvdr"),
        "mvdr3": estimator("mvdr", weight_refresh=3),
        "music_subspace": estimator("music", solver="subspace"),
        "music_eigh": estimator("music", solver="eigh"),
    }


def _rank_main(out_dir, rank):
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), WORLD),
        rank=rank, world_size=WORLD)
    with np.load(os.path.join(out_dir, "inputs.npz")) as data:
        inputs = dict(data)
    out = {}
    for name, case in _rank_cases().items():
        try:
            for k, v in case(inputs).items():
                out[f"{name}/{k}"] = (v.numpy() if isinstance(v, torch.Tensor)
                                      else np.asarray(v))
        except Exception:       # reported by the case's test
            out[f"{name}/error"] = np.array(traceback.format_exc())
    out["jax_loaded"] = np.array("jax" in sys.modules)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


# ---------------------------------------------------------- the test side

def _spawn(out_dir, world):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              str(out_dir), str(r)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, env=env) for r in range(world)]


def _join(procs, out_dir, timeout=120):
    """Each rank's outputs; raises when a rank fails or outlives the
    timeout (every rank is stopped)."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    ranks = []
    for r in range(len(procs)):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as data:
            ranks.append(dict(data))
    return ranks


def _save_jax_state(inputs, prefix, state):
    import jax

    from beamforming_lk_tpu.io.checkpoint import _flatten_with_paths

    flat, _ = _flatten_with_paths(jax.tree.map(np.asarray, state))
    inputs.update({f"{prefix}{k}": v for k, v in flat.items()})


def _key_draws(key, tc):
    """The draws of one JAX swarm step from its state's key (split for the
    seeker reset, then the jump draw), and the key after the step."""
    import jax

    from beamforming_lk_tpu.models import tracker as jtk

    key, sub = jax.random.split(key)
    r_th, r_ph = jtk._random_directions(sub, tc.n_seekers, tc.theta_limit)
    key, jts, jps = jtk._swarm_jumps(key, tc.iterations, tc.n_seekers,
                                     tc.theta_limit / 2.0)
    return tuple(np.asarray(x) for x in (r_th, r_ph, jts, jps)), key


def _jax_awpu(inputs, case, iterations, backend="dense", mask=True,
              n_blocks=3, seed=3, batch=False):
    """The JAX sharded AWPU pipeline on a (2, 2) mesh of 4 devices: puts its
    initial state, draws and blocks in ``inputs`` for the ranks and returns
    ``run() -> (last outputs, state)``, which steps it."""
    import jax
    import jax.numpy as jnp

    from beamforming_lk_tpu import config as jcfg
    from beamforming_lk_tpu.app import awpu_init, make_awpu_step
    from beamforming_lk_tpu.io.synthetic import plane_wave_block
    from beamforming_lk_tpu.parallel import mesh as jpm

    cfg = jcfg.Config(mimo=jcfg.MimoConfig(rows=16, columns=16, backend=backend),
                      tracker=jcfg.TrackerConfig(iterations=iterations))
    pts = inputs["points"]
    blocks = np.stack([plane_wave_block(pts, [SRC], b * 256, 256, cfg.array,
                                        noise_std=0.02) for b in range(n_blocks)])
    mesh = jpm.make_mesh((2, 2), devices=jax.devices()[:WORLD])
    state = awpu_init(cfg, pts.shape[1], mesh=mesh, seed=seed)
    _save_jax_state(inputs, f"{case}/state0", state)
    inputs[f"{case}/blocks"] = blocks
    key = state.swarm.key
    for i in range(n_blocks):
        draws, key = _key_draws(key, cfg.tracker)
        for j, d in enumerate(draws):
            inputs[f"{case}/draws{i}/{j}"] = d
    mask = inputs["mask"] if mask else None

    def run(state=state):
        step = make_awpu_step(pts, cfg, channel_mask=mask, mesh=mesh)
        if batch:
            state, outs = step.scan(state, jnp.asarray(blocks))
            out = jax.tree.map(lambda x: x[-1], outs)
        else:
            for blk in blocks:
                state, out = step(state, jnp.asarray(blk))
        return jax.tree.map(np.asarray, (out, state))
    return run


def _jax_inputs():
    """Inputs of every case, made with the JAX package (numpy out)."""
    import jax.numpy as jnp

    from beamforming_lk_tpu.config import ArrayConfig, DspConfig, MimoConfig
    from beamforming_lk_tpu.io import ring as rg
    from beamforming_lk_tpu.io.synthetic import plane_wave_block
    from beamforming_lk_tpu.models import mimo as mm
    from beamforming_lk_tpu.ops import antenna as ant

    acfg, dcfg = ArrayConfig(), DspConfig(shift_range=64)
    points = ant.create_antenna_grid(acfg.columns, acfg.rows, acfg.distance)
    model = mm.make_mimo_model(points, MimoConfig(rows=16, columns=16), dcfg, acfg)
    block = plane_wave_block(points, [(0.4, 1.0, 4000.0)], 0, dcfg.block_size,
                             acfg, noise_std=0.05)
    hist = rg.ring_push(rg.ring_init(64, dcfg.history), jnp.asarray(block))
    window = rg.ring_window(hist, dcfg.block_size, dcfg.shift_range, model.taps)
    mask = np.ones(64, np.float32)
    mask[13] = 0.0                       # one dead mic, as calibration gives
    inputs = dict(points=points, mask=mask, block=block, history=np.asarray(hist),
                  window=np.asarray(window), weights=np.asarray(model.weights),
                  theta=model.theta, phi=model.phi)

    dmany = DspConfig(shift_range=192, history=1024)
    mmany = MimoConfig(rows=8, columns=8)
    pmany = ant.multi_array_cluster(MANY_MICS)
    th, ph = mm.make_mimo_grid(mmany)
    bmany = plane_wave_block(pmany, [(0.3, 0.6, 3000.0)], 0, dmany.block_size,
                             acfg, noise_std=0.02)
    hmany = rg.ring_push(rg.ring_init(MANY_MICS, dmany.history), jnp.asarray(bmany))
    inputs.update({
        "many/delays": ant.steering_delays_np(pmany, th, ph, acfg.samples_per_meter),
        "many/window": np.asarray(rg.ring_window(hmany, dmany.block_size, 192, 2)),
        "many/theta": th, "many/phi": ph,
    })

    est_th, est_ph = mm.make_mimo_grid(MimoConfig(rows=12, columns=12))
    inputs.update({
        "est/points": points, "est/theta": est_th, "est/phi": est_ph,
        "est/blocks": np.stack([plane_wave_block(
            points, [(0.5, 1.2, 4000.0)], b * 256, 256, acfg, noise_std=0.05)
            for b in range(5)]),
    })
    return inputs


def _jax_outputs(inputs):
    """The JAX package's sharded results of every case."""
    import jax
    import jax.numpy as jnp

    from beamforming_lk_tpu import config as jcfg
    from beamforming_lk_tpu.models import mvdr as jmv
    from beamforming_lk_tpu.models import music as jmu
    from beamforming_lk_tpu.ops import delay as jdl
    from beamforming_lk_tpu.parallel import (
        make_sharded_das_power, make_time_sharded_beam, shard_weights,
        shard_window,
    )
    from beamforming_lk_tpu.parallel import mesh as jpm
    from beamforming_lk_tpu.parallel.das import make_sharded_mimo_step

    devs = jax.devices()[:WORLD]
    window, weights = jnp.asarray(inputs["window"]), jnp.asarray(inputs["weights"])
    ref = {"factoring/mesh": jpm.make_mesh(devices=devs)}
    for case, shape in (("ch_dir_power", (2, 2)), ("dir_power", (1, 4))):
        mesh = jpm.make_mesh(shape, devices=devs)
        f = make_sharded_das_power(mesh, use_bandpass=True)
        ref[case] = np.asarray(f(shard_window(window, mesh), shard_weights(weights, mesh)))
    mesh = jpm.make_mesh((2, 2), axis_names=(jpm.DIR_AXIS, jpm.TIME_AXIS), devices=devs)
    ref["time_beam"] = np.asarray(make_time_sharded_beam(mesh)(
        window[:, 64:], window[:, :64], weights))
    mesh = jpm.make_mesh((1, 2), axis_names=(jpm.DIR_AXIS, jpm.TIME_AXIS),
                         devices=devs[:2])
    ref["time_beam_1x2"] = np.asarray(make_time_sharded_beam(mesh)(
        window[:, 64:], window[:, :64], weights))
    mesh = jpm.make_mesh((2, 2), devices=devs)
    step = make_sharded_mimo_step(mesh, block_size=256, shift_range=64, taps=2)
    hist = jax.device_put(jnp.zeros((64, 1024), jnp.float32),
                          jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("ch", None)))
    ref["streaming"] = tuple(np.asarray(x) for x in step(
        hist, jnp.asarray(inputs["block"]), shard_weights(weights, mesh)))
    mesh = jpm.make_mesh((4, 1), devices=devs)
    w_many = jdl.das_weights_np(inputs["many/delays"], 192)
    f = make_sharded_das_power(mesh, use_bandpass=True)
    ref["many_array"] = np.asarray(f(shard_window(jnp.asarray(inputs["many/window"]), mesh),
                                     shard_weights(jnp.asarray(w_many), mesh)))

    mesh = jpm.make_mesh((1, 4), devices=devs)
    args = (inputs["est/points"], inputs["est/theta"], inputs["est/phi"], mesh)
    for case, make, kw in (
            ("mvdr", jmv.make_sharded_mvdr_step, {}),
            ("mvdr3", jmv.make_sharded_mvdr_step, dict(weight_refresh=3)),
            ("music_subspace", jmu.make_sharded_music_step,
             dict(n_sources=2, solver="subspace")),
            ("music_eigh", jmu.make_sharded_music_step,
             dict(n_sources=2, solver="eigh"))):
        step, state = make(*args, array_cfg=jcfg.ArrayConfig(), **kw)
        powers = []
        for blk in inputs["est/blocks"]:
            state, p = step(state, jnp.asarray(blk))
            powers.append(np.asarray(p))
        ref[case] = np.stack(powers)
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, JAX results, each rank's outputs): the inputs first, then
    the ranks, and the JAX package's runs while they run."""
    out_dir = tmp_path_factory.mktemp("mesh4")
    inputs = _jax_inputs()
    runs = {"fused": _jax_awpu(inputs, "fused", 2),
            "scan": _jax_awpu(inputs, "scan", 1, mask=False, n_blocks=4, seed=7,
                              batch=True),
            "fft": _jax_awpu(inputs, "fft", 2, backend="fft", mask=False,
                             n_blocks=2)}
    np.savez(out_dir / "inputs.npz", **inputs)
    procs = _spawn(out_dir, WORLD)
    try:
        ref = {case: run() for case, run in runs.items()}
        ref.update(_jax_outputs(inputs))
    finally:
        ranks = _join(procs, out_dir)
    return inputs, ref, ranks


def _case(ranks, case):
    """Every rank's outputs of ``case``; fails with a rank's traceback."""
    for r, out in enumerate(ranks):
        assert f"{case}/error" not in out, f"rank {r}:\n{out[f'{case}/error']}"
    return [{k.split("/", 1)[1]: v for k, v in out.items()
             if k.startswith(case + "/")} for out in ranks]


def _by_coordinate(outs, key, axis_of):
    """Assemble the blocks ``key`` of the ranks along their mesh
    coordinate (``axis_of``: the coordinate entry that orders each block
    axis), one rank per block."""
    blocks = {}
    for o in outs:
        blocks[tuple(int(o["coordinate"][a]) for a in axis_of)] = o[key]
    n = [max(k[i] for k in blocks) + 1 for i in range(len(axis_of))]
    if len(n) == 1:
        return np.concatenate([blocks[(i,)] for i in range(n[0])])
    return np.block([[blocks[(i, j)] for j in range(n[1])] for i in range(n[0])])


def test_ranks_load_no_jax(run):
    assert not any(bool(out["jax_loaded"]) for out in run[2])


def test_mesh_factoring(run):
    """``make_mesh()`` on 4 ranks: the most-square (2, 2) split over (ch,
    dir), ranks laid out row-major as the JAX mesh lays out its devices."""
    jmesh = run[1]["factoring/mesh"]
    outs = _case(run[2], "factoring")
    for r, o in enumerate(outs):
        assert tuple(o["shape"]) == jmesh.devices.shape == (2, 2)
        assert tuple(o["names"]) == jmesh.axis_names == ("ch", "dir")
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)
        assert ids[tuple(o["coordinate"])] == jmesh.devices.flat[r].id


@pytest.mark.parametrize("case", ["ch_dir_power", "dir_power"])
def test_sharded_power_matches_jax(run, case):
    """(ch, dir) = (2, 2) and dir-only (1, 4) heatmap powers."""
    got = _by_coordinate(_case(run[2], case), "powers", (1,))
    np.testing.assert_allclose(got, run[1][case], rtol=2e-4, atol=1e-12)


def test_time_sharded_beam_matches_jax(run):
    """(dir, t) = (2, 2): each time chunk takes its halo from its left
    neighbour.  The sharded beam against the port's dense one at the JAX
    package's bound for the same comparison; the beam against the JAX
    package's within 1e-5 of its peak (two f32 products of 4096 terms in
    other orders)."""
    outs = _case(run[2], "time_beam")
    got = _by_coordinate(outs, "beam", (0, 1))
    np.testing.assert_allclose(got, _by_coordinate(outs, "dense", (0, 1)),
                               rtol=2e-4, atol=1e-10)
    want = run[1]["time_beam"]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_time_sharded_beam_at_the_cards_shape_matches_jax(run):
    """(dir, t) = (1, 2), the shape of chip_smoke.py's phase 15c: every
    direction on both ranks, the second rank's halo from the first, on each
    of two pairs of ranks.  The (2, 2) case's bounds: rtol 2e-4 / atol
    1e-10 against the one-rank beam of the rank's own span of the window
    (the same product, so the halo's samples are the window's), and within
    1e-5 of the peak against the JAX package's beam on two of its virtual
    devices and against the one-rank beam of the whole block (products of
    another width, which sum 4096 terms in another order: 16 of 65 536
    entries near zero differ by 3.7e-9, past atol 1e-10)."""
    outs = _case(run[2], "time_beam_1x2")
    want = run[1]["time_beam_1x2"]
    peak = np.abs(want).max()
    for replica in (0, 1):
        pair = [o for o in outs if o["coordinate"][0] == replica]
        got = _by_coordinate(pair, "beam", (1, 2))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, _by_coordinate(pair, "own", (1, 2)),
                                   rtol=2e-4, atol=1e-10)
        for ref in (want, _by_coordinate(pair, "dense", (1, 2))):
            assert np.abs(got - ref).max() <= 1e-5 * peak


def test_sharded_streaming_step_matches_jax(run):
    """The streaming step on (2, 2): powers, and the pushed history bit for
    bit."""
    outs = _case(run[2], "streaming")
    hist, powers = run[1]["streaming"]
    np.testing.assert_allclose(_by_coordinate(outs, "powers", (1,)), powers,
                               rtol=2e-4, atol=1e-12)
    ch0 = [o for o in outs if o["coordinate"][1] == 0]
    np.testing.assert_array_equal(_by_coordinate(ch0, "history", (0,)), hist)
    inputs = run[0]
    d = int(np.argmax(powers))
    from beamforming_lk_tpu.ops.geometry import spherical_angle

    assert float(spherical_angle(inputs["theta"][d], inputs["phi"][d], 0.4, 1.0)) < np.radians(12.0)


def test_many_array_channel_sharded_heatmap(run):
    """1024 mics (16 arrays) channel-sharded over 4 ranks: powers match the
    JAX package's, the peak on the source."""
    outs = _case(run[2], "many_array")
    for o in outs:
        np.testing.assert_allclose(o["powers"], run[1]["many_array"],
                                   rtol=3e-4, atol=1e-13)
    inputs = run[0]
    d = int(np.argmax(outs[0]["powers"]))
    from beamforming_lk_tpu.ops.geometry import spherical_angle

    assert float(spherical_angle(inputs["many/theta"][d], inputs["many/phi"][d],
                                 0.3, 0.6)) < np.radians(15)


def _hold_awpu(outs, jout, jstate):
    """The sharded step against the port's unsharded one and against the
    JAX package's sharded one, at the JAX package's sharded-vs-dense
    bounds (``tests/test_awpu.py``); the history bit for bit.  The MISO
    beam is held to those bounds against the port's unsharded beam, and
    against the JAX package's within 1e-3 of its peak: after 3 blocks the
    listener sits 0.056 rad off boresight, where a phi step divides by
    sin(theta), and the port's Cartesian probes round otherwise than the
    JAX chain's acos/atan2 ones (ROADMAP §3): the unsharded pipelines
    differ by 4.1e-4 of the peak there."""
    np.testing.assert_allclose(_by_coordinate(outs, "powers", (1,)), jout.powers,
                               rtol=2e-4, atol=1e-14)
    peak = np.abs(jout.miso_beam).max()
    for o in outs:
        np.testing.assert_allclose(o["powers"], o["dense_powers"], rtol=2e-4, atol=1e-14)
        np.testing.assert_allclose(o["miso_beam"], o["dense_beam"], rtol=2e-3, atol=2e-5)
        assert np.abs(o["miso_beam"] - jout.miso_beam).max() <= 1e-3 * peak
        for want_valid, want_theta in ((o["dense_valid"], o["dense_theta"]),
                                       (jout.targets.valid, jout.targets.theta)):
            np.testing.assert_array_equal(o["valid"], want_valid)
            np.testing.assert_allclose(o["theta"], want_theta, rtol=1e-3, atol=1e-4)
    ch0 = [o for o in outs if o["coordinate"][1] == 0]
    np.testing.assert_array_equal(_by_coordinate(ch0, "history", (0,)),
                                  jstate.history)


def test_fused_step_sharded_with_dead_mic_matches_jax(run):
    """The fused tracker + MISO step with the dense heatmap on (2, 2) and
    mic 13 dead, 3 blocks from the JAX state and draws: powers, the MISO
    beam, targets and the history."""
    jout, jstate = run[1]["fused"]
    _hold_awpu(_case(run[2], "fused"), jout, jstate)
    assert jout.targets.valid.any()


def test_swarm_is_equal_on_every_rank(run):
    """The replicated swarm agrees bit for bit across the ranks."""
    outs = _case(run[2], "fused")
    for o in outs[1:]:
        np.testing.assert_array_equal(o["swarm"], outs[0]["swarm"])


def test_process_blocks_under_a_mesh_matches_jax(run):
    """``process_blocks`` of 4 blocks on (2, 2) (block by block) against the
    JAX sharded scan."""
    jout, _ = run[1]["scan"]
    outs = _case(run[2], "scan")
    np.testing.assert_allclose(_by_coordinate(outs, "powers", (1,)), jout.powers,
                               rtol=2e-4, atol=1e-13)
    for o in outs:
        np.testing.assert_allclose(o["powers"], o["dense_powers"], rtol=2e-4, atol=1e-13)


def test_fft_falls_back_to_dense_under_channel_sharding(run):
    """``backend="fft"`` with ch = 2 prints the JAX package's note and runs
    the dense heatmap, with the JAX package's powers."""
    jout, jstate = run[1]["fft"]
    outs = _case(run[2], "fft")
    assert all("using dense" in str(o["note"]) for o in outs)
    _hold_awpu(outs, jout, jstate)


def test_state_from_jax_is_placed_as_awpu_init_places_it(run):
    """``convert.awpu_state_from_jax(state, mesh=m)`` of a whole fresh
    state gives each rank the shards that ``awpu_init(cfg, c, mesh=m)``
    gives it, on the same device, leaf for leaf."""
    for o in _case(run[2], "placement"):
        n = int(o["n_leaves"])
        np.testing.assert_array_equal(o["converted_devices"], o["init_devices"])
        assert set(o["init_devices"]) == {"cpu"}
        for i in range(n):
            np.testing.assert_array_equal(o[f"converted{i}"], o[f"init{i}"])
        assert o["converted0"].shape == (32, _awpu_cfg(1).dsp.history)


@pytest.mark.parametrize("case", ["mvdr", "mvdr3"])
def test_bin_sharded_mvdr_matches_jax(run, case):
    """Bins over dir = 4 (11 bins padded to 12), solved every block and
    every 3rd: against the port's own dense step at the JAX package's
    sharded bound, and against the JAX sharded step at
    ``tests/test_torch_mvdr.py``'s 2e-3."""
    outs = _case(run[2], case)
    want = run[1][case]
    for o in outs:
        assert int(o["bins"]) == 3
        np.testing.assert_allclose(o["powers"], o["dense"], rtol=5e-4)
        np.testing.assert_allclose(o["powers"], want, rtol=2e-3)
        assert int(np.argmax(o["powers"][-1])) == int(np.argmax(want[-1]))


@pytest.mark.parametrize("solver", ["subspace", "eigh"])
def test_bin_sharded_music_matches_dense(run, solver):
    """MUSIC's bins over dir = 4: against the port's dense step at the JAX
    package's sharded bound, the argmax as the JAX sharded step's."""
    outs = _case(run[2], f"music_{solver}")
    want = run[1][f"music_{solver}"]
    for o in outs:
        np.testing.assert_allclose(o["powers"], o["dense"], rtol=5e-4)
        assert int(np.argmax(o["powers"][-1])) == int(np.argmax(want[-1]))


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
