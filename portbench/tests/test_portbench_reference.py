"""The plain reference against the port run on the CPU (``device="cpu"``,
the kernels' plain twins) at 64 mics over a few blocks."""

import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference import geometry as geo
from portbench.reference import heatmap as ref_map
from portbench.tests.portbench_cells import SECONDS, small_cell

CELLS = tuple(SECONDS)


def test_geometry_is_the_port_geometry():
    from beamforming_lk_tpu_torch.ops import antenna as ant

    for c in (64, 256):
        np.testing.assert_allclose(geo.array_points(c, 8, 8, 0.02),
                                   ant.multi_array_cluster(c), atol=1e-7)


@pytest.mark.parametrize("name", ["lk256-rt", "lk64-default"])
def test_heatmap_matches_the_port_heatmap(name):
    from beamforming_lk_tpu_torch.app.awpu import AwpuStep
    from beamforming_lk_tpu_torch.io import ring

    spec = small_cell("lk256-rt-live" if name == "lk256-rt" else "lk64-default-stream")
    cfg = dict(spec["config"])
    cfg["dsp"] = dict(cfg["dsp"], compute="float32")
    pts = geo.array_points(64, 8, 8, 0.02)
    step = AwpuStep(pts, run.port_config(cfg), device="cpu")
    d = cfg["dsp"]
    window = torch.randn((64, d["block_size"] + d["shift_range"]),
                         generator=torch.Generator().manual_seed(3)) * 1e-2
    got = step._maps(window)
    want = ref_map.powers(window, pts, cfg)
    assert float((got.double() - want).abs().max() / want.max()) < 1e-5
    assert ring.LOOKAHEAD_GUARD == 8


@pytest.mark.parametrize("workload", CELLS)
def test_reference_follows_the_port(workload):
    spec = small_cell(workload)
    result, shown = run.run_cell(spec, 2 ** 31 + 11, SECONDS[workload], False,
                                 device="cpu")
    numbers = {k: v["value"] for k, v in shown.items()}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert numbers["history_gap"] == 0.0
    bf16 = spec["config"]["dsp"]["compute"] == "bfloat16"
    assert numbers["map_gap"] < (2e-2 if bf16 else 1e-5)
    assert numbers["target_gap_rad"] < (1e-3 if bf16 else 1e-5)
    assert numbers["beam_gap"] < (1e-2 if bf16 else 1e-4)
    assert numbers.get("state_gap_rad", 0.0) < (1e-2 if bf16 else 1e-5)
    assert numbers.get("chunk_gap_rad", 0.0) < 1e-3


@pytest.mark.parametrize("name, m", [("lk256-rt", 1), ("lk256-rt", 12), ("lk64-default", 1)])
def test_reference_draws_are_the_pipelines_own(name, m):
    """The pipeline fed the reference's draws through its test hook gives
    what it gives with its own generator, over blocks with seeker resets."""
    from beamforming_lk_tpu_torch.app import AwpuPipeline
    from portbench.reference.draws import SwarmDraws
    from portbench.traffic import Traffic

    spec = small_cell("lk256-rt-replay" if name == "lk256-rt" else "lk64-default-stream")
    cfg = dict(spec["config"])
    cfg["tracker"] = dict(cfg["tracker"], seeker_reset_interval=5)
    seed, n = 2 ** 31 + 77, 24
    feed = Traffic(dict(spec["traffic"], pool_blocks=n), cfg, seed, "cpu")
    draws = SwarmDraws(seed, cfg["tracker"], "cpu").of_blocks(range(n))
    zeros = torch.zeros(cfg["tracker"]["n_seekers"])

    def given(k):
        rt, rp, jt, jp = draws[k]
        return tuple(x.numpy() for x in (zeros if rt is None else rt,
                                          zeros if rp is None else rp, jt, jp))

    own, fed = (AwpuPipeline(run.port_config(cfg), channels=cfg["channels"], seed=seed,
                             device="cpu") for _ in range(2))
    for k0 in range(0, n, m):
        blocks = feed.batch(k0, m)
        if m == 1:
            a, b = own.process_block(blocks[0]), fed.process_block(blocks[0], draws=given(k0))
        else:
            d = [given(k) for k in range(k0, k0 + m)]
            a = own.process_blocks(blocks)
            b = fed.process_blocks(blocks, draws=tuple(np.stack(x) for x in zip(*d)))
        for x, y in ((a.targets.theta, b.targets.theta), (a.targets.phi, b.targets.phi),
                     (a.targets.valid, b.targets.valid), (a.miso_beam, b.miso_beam)):
            assert torch.equal(x, y), k0
    assert torch.equal(own.state.swarm.seekers.theta, fed.state.swarm.seekers.theta)
