"""The port's multi-host path on two spawned CPU ranks (gloo, rendezvous
through a ``FileStore`` under the test's temporary directory), as the JAX
package's ``tests/test_multihost.py`` runs two ``jax.distributed``
processes: each rank holds half the channels, wraps them with
``global_block_from_local`` and runs the sharded step, which must match
the single-device result.  Under the same (2, 1) mesh: ``calibrate``,
``save`` and ``restore``; under (1, 2): ``ControlUnit(mesh=)``, whose first
rank alone writes.  In this process: the one-process helpers
(``tests/test_control.py::test_multihost_helper_single_process``) and the
mesh's checks.

The ranks import no JAX; this file is also their program:
``python tests/test_torch_multihost.py DIR RANK``.  Bounds are the JAX
package's (``tests/_multihost_worker.py``: powers 3e-4, the swarm 1e-3 /
1e-5; ``tests/test_awpu.py``: powers 2e-4).
"""

import os
import subprocess
import sys
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
SRC = (0.5, 2.0, 5000.0)


def _host_cfg():
    """The JAX package's multi-host worker configuration."""
    from beamforming_lk_tpu_torch import config as tcfg

    return tcfg.Config(
        dsp=tcfg.DspConfig(block_size=128, history=512, shift_range=64),
        mimo=tcfg.MimoConfig(rows=8, columns=8),
        tracker=tcfg.TrackerConfig(iterations=1, tracker_steps=1),
    )


def _cfg(iterations=2):
    from beamforming_lk_tpu_torch import config as tcfg

    return tcfg.Config(mimo=tcfg.MimoConfig(rows=16, columns=16),
                       tracker=tcfg.TrackerConfig(iterations=iterations))


def _plane_blocks(points, n, block=256, source=SRC, dead=None):
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block

    blocks = np.stack([plane_wave_block(points, [source], b * block, block,
                                        noise_std=0.02) for b in range(n)])
    if dead is not None:
        blocks[:, dead] = 0.0
    return blocks


def _unit(mesh=None):
    from beamforming_lk_tpu_torch.app.control import ControlUnit

    return ControlUnit(_cfg(1), enable_miso=True, mesh=mesh, device="cpu")


def _control_run(unit, blocks, out_dir):
    """The unit's run over ``blocks``, writing frames and the MISO WAV
    under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    unit.run([list(blocks)], n_blocks=len(blocks), render_every=2,
             output_dir=os.path.join(out_dir, "frames"),
             miso_wav=os.path.join(out_dir, "beam.wav"))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# ---------------------------------------------------------------- the ranks

def _rank_cases(out_dir, rank):
    from beamforming_lk_tpu_torch.app import AwpuPipeline, awpu_init, make_awpu_step
    from beamforming_lk_tpu_torch.ops import antenna as ant
    from beamforming_lk_tpu_torch.parallel import make_mesh
    from beamforming_lk_tpu_torch.parallel.multihost import global_block_from_local

    points = ant.create_antenna_grid()

    def multihost():
        cfg = _host_cfg()
        mesh = make_mesh((WORLD, 1), device_type="cpu")
        mask = np.ones(64, np.float32)
        blocks = _plane_blocks(points, 3, block=128, source=(0.4, 1.0, 5000.0))
        step = make_awpu_step(points, cfg, channel_mask=mask, mesh=mesh, device="cpu")
        gen = torch.Generator().manual_seed(0)
        state = awpu_init(cfg, 64, mesh=mesh, device="cpu", generator=gen)
        ref_step = make_awpu_step(points, cfg, channel_mask=mask, device="cpu")
        ref_gen = torch.Generator().manual_seed(0)
        ref = awpu_init(cfg, 64, device="cpu", generator=ref_gen)
        lo = rank * 32
        got, want = [], []
        for blk in blocks:
            g = global_block_from_local(blk[lo:lo + 32], mesh)
            assert tuple(g.shape) == (64, 128)
            assert torch.equal(g.to_local(), torch.as_tensor(blk[lo:lo + 32]))
            state, out = step(state, g.to_local(), generator=gen)
            ref, ref_out = ref_step(ref, torch.as_tensor(blk), generator=ref_gen)
            got.append(out.powers)
            want.append(ref_out.powers)
        return dict(powers=torch.stack(got), dense=torch.stack(want),
                    theta=state.swarm.trackers.theta,
                    dense_theta=ref.swarm.trackers.theta)

    def calibrate():
        mesh = make_mesh((WORLD, 1), device_type="cpu")
        kw = dict(points=points, seed=2, enable_tracker=False,
                  enable_miso=False, device="cpu")
        pipe = AwpuPipeline(_cfg(1), mesh=mesh, **kw)
        ref = AwpuPipeline(_cfg(1), **kw)
        blocks = _plane_blocks(points, 5, dead=21)
        lo = rank * 32
        result = pipe.calibrate([global_block_from_local(b[lo:lo + 32], mesh)
                                 for b in blocks[:4]])
        want = ref.calibrate(blocks[:4])
        out = pipe.process_block(blocks[4])
        ref_out = ref.process_block(blocks[4])
        return dict(mask=result.mask, dense_mask=want.mask, powers=out.powers,
                    dense=ref_out.powers, history=pipe.state.history,
                    dense_history=ref.state.history[lo:lo + 32])

    def save_restore():
        mesh = make_mesh((WORLD, 1), device_type="cpu")
        path = os.path.join(out_dir, "state.npz")
        blocks = _plane_blocks(points, 5)
        pipe = AwpuPipeline(_cfg(), points=points, mesh=mesh, seed=4, device="cpu")
        for b in blocks[:3]:
            pipe.process_block(b)
        pipe.save(path)
        other = AwpuPipeline(_cfg(), points=points, mesh=mesh, seed=9, device="cpu")
        other.restore(path)
        outs = []
        for p in (pipe, other):
            for b in blocks[3:]:
                out = p.process_block(b)
            outs.append(out)
        sw = [torch.cat([torch.cat(p.state.swarm.seekers),
                         torch.cat(p.state.swarm.trackers)]) for p in (pipe, other)]
        with np.load(path) as data:
            saved = data[".history"]
        return dict(powers=outs[0].powers, restored_powers=outs[1].powers,
                    beam=outs[0].miso_beam, restored_beam=outs[1].miso_beam,
                    swarm=sw[0], restored_swarm=sw[1], saved_history=saved,
                    block_index=np.array([pipe.state.block_index,
                                          other.state.block_index]))

    def control():
        mesh = make_mesh((1, WORLD), device_type="cpu")
        _control_run(_unit(mesh), _plane_blocks(points, 6),
                     os.path.join(out_dir, f"control{rank}"))
        return dict(done=np.array(True))

    return {"multihost": multihost, "calibrate": calibrate,
            "save_restore": save_restore, "control": control}


def _rank_main(out_dir, rank):
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), WORLD),
        rank=rank, world_size=WORLD)
    out = {}
    for name, case in _rank_cases(out_dir, rank).items():
        try:
            for k, v in case().items():
                out[f"{name}/{k}"] = (v.numpy() if isinstance(v, torch.Tensor)
                                      else np.asarray(v))
        except Exception:       # reported by the case's test
            out[f"{name}/error"] = np.array(traceback.format_exc())
    out["jax_loaded"] = np.array("jax" in sys.modules)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


# ---------------------------------------------------------- the test side

def _spawn(out_dir):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              str(out_dir), str(r)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, env=env) for r in range(WORLD)]


def _join(procs, out_dir, timeout=120):
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


def _jax_host_powers():
    """The JAX package's single-device heatmap powers of the multi-host
    worker's 3 blocks (they depend on the data alone)."""
    import jax.numpy as jnp

    from beamforming_lk_tpu import config as jcfg
    from beamforming_lk_tpu.app import awpu_init, make_awpu_step
    from beamforming_lk_tpu.ops import antenna as jant

    cfg = jcfg.Config(
        dsp=jcfg.DspConfig(block_size=128, history=512, shift_range=64),
        mimo=jcfg.MimoConfig(rows=8, columns=8),
        tracker=jcfg.TrackerConfig(iterations=1, tracker_steps=1),
    )
    points = jant.create_antenna_grid()
    step = make_awpu_step(points, cfg, channel_mask=np.ones(64, np.float32))
    state = awpu_init(cfg, 64, seed=0)
    powers = []
    for blk in _plane_blocks(points, 3, block=128, source=(0.4, 1.0, 5000.0)):
        state, out = step(state, jnp.asarray(blk))
        powers.append(np.asarray(out.powers))
    return np.stack(powers)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the test side's references, each rank's outputs)."""
    from beamforming_lk_tpu_torch.ops import antenna as ant

    out_dir = tmp_path_factory.mktemp("mesh2")
    procs = _spawn(out_dir)
    try:
        one = out_dir / "one_process"
        _control_run(_unit(), _plane_blocks(ant.create_antenna_grid(), 6), str(one))
        ref = {"jax_powers": _jax_host_powers(), "control": str(one)}
    finally:
        ranks = _join(procs, out_dir)
    return ref, ranks, out_dir


def _case(ranks, case):
    for r, out in enumerate(ranks):
        assert f"{case}/error" not in out, f"rank {r}:\n{out[f'{case}/error']}"
    return [{k.split("/", 1)[1]: v for k, v in out.items()
             if k.startswith(case + "/")} for out in ranks]


def test_ranks_load_no_jax(run):
    assert not any(bool(out["jax_loaded"]) for out in run[1])


def test_two_process_fused_step_parity(run):
    """Two ranks, each with its half of the channels through
    ``global_block_from_local``, against the single-device step and the
    JAX package's powers; the swarm against the single-device one."""
    for o in _case(run[1], "multihost"):
        np.testing.assert_allclose(o["powers"], o["dense"], rtol=3e-4, atol=1e-12)
        np.testing.assert_allclose(o["powers"], run[0]["jax_powers"],
                                   rtol=3e-4, atol=1e-12)
        np.testing.assert_allclose(o["theta"], o["dense_theta"], rtol=1e-3, atol=1e-5)


def test_calibrate_under_a_mesh(run):
    """``calibrate`` on (2, 1) from ``DTensor`` blocks gathers the history:
    the dead mic masked as on one device, the next powers as one
    device's, each rank's history its channels of the single-device
    one."""
    for o in _case(run[1], "calibrate"):
        np.testing.assert_array_equal(o["mask"], o["dense_mask"])
        assert o["mask"][21] == 0.0 and o["mask"].sum() >= 60
        np.testing.assert_allclose(o["powers"], o["dense"], rtol=2e-4, atol=1e-14)
        np.testing.assert_array_equal(o["history"], o["dense_history"])


def test_save_and_restore_under_a_mesh(run):
    """``save`` on (2, 1): the first rank writes the gathered state;
    ``restore`` on every rank: a pipeline of another seed continues bit
    for bit as the saved one."""
    outs = _case(run[1], "save_restore")
    for o in outs:
        assert tuple(o["block_index"]) == (5, 5)
        assert o["saved_history"].shape == (64, 1024)
        for k in ("powers", "beam", "swarm"):
            np.testing.assert_array_equal(o[k], o[f"restored_{k}"])
    np.testing.assert_array_equal(outs[0]["saved_history"], outs[1]["saved_history"])


def test_control_unit_under_a_mesh(run):
    """``ControlUnit(mesh=)`` on (1, 2): the first rank's WAV and frames
    equal the one-process run's, bit for bit; the other rank writes
    nothing."""
    ref, ranks, out_dir = run
    _case(ranks, "control")
    root, other = (os.path.join(str(out_dir), f"control{r}") for r in range(WORLD))
    assert _files(other) == []
    assert _files(root) == _files(ref["control"]) and "beam.wav" in _files(root)
    for name in _files(root):
        with open(os.path.join(root, name), "rb") as a, \
                open(os.path.join(ref["control"], name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.fixture
def group(tmp_path):
    """A one-process gloo group for the test, torn down after it."""
    import torch.distributed as dist

    from beamforming_lk_tpu_torch.parallel.multihost import initialize

    assert initialize(backend="gloo") == 0
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def test_initialize_picks_nccl_only_with_cuda():
    """With no backend named, ``initialize()`` starts NCCL on a host with
    CUDA and gloo on one without."""
    import torch.distributed as dist

    from beamforming_lk_tpu_torch.parallel.multihost import initialize

    assert initialize() == 0
    try:
        want = "nccl" if torch.cuda.is_available() else "gloo"
        assert dist.get_backend() == want
    finally:
        dist.destroy_process_group()


def test_multihost_helper_single_process(group):
    """``initialize()`` with no launcher starts a one-process group, and
    ``global_block_from_local`` on a 1x1 mesh is the block itself."""
    from beamforming_lk_tpu_torch.parallel import make_mesh, single_device_mesh
    from beamforming_lk_tpu_torch.parallel.multihost import (
        global_block_from_local, initialize,
    )

    assert initialize() == 0 and group.get_world_size() == 1
    mesh = make_mesh((1, 1), device_type="cpu")
    local = np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32)
    arr = global_block_from_local(local, mesh)
    assert tuple(arr.shape) == (64, 32)
    np.testing.assert_array_equal(arr.full_tensor().numpy(), local)
    np.testing.assert_array_equal(arr.to_local().numpy(), local)
    assert single_device_mesh(device_type="cpu").mesh_dim_names == ("ch", "dir")


def test_mesh_refuses_what_it_cannot_build(group):
    """A shape that is not the world size, a CUDA mesh on a host without
    CUDA, and a mesh that is not a ``DeviceMesh`` raise; no fallback."""
    from beamforming_lk_tpu_torch.parallel import make_mesh
    from beamforming_lk_tpu_torch.parallel.mesh import Layout

    with pytest.raises(ValueError, match="ranks"):
        make_mesh((2, 1), device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh((1, 1))
    with pytest.raises(TypeError, match="DeviceMesh"):
        Layout(object())
    with pytest.raises(ValueError, match="device"):
        Layout(make_mesh((1, 1), device_type="cpu")).device("meta")


def test_make_mesh_needs_a_process_group():
    from beamforming_lk_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), device_type="cpu")


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
