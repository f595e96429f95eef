"""Parity of the port's plain ops (config, geometry, antenna, delay, ring,
synthetic source, heatmap grid/render) with the JAX package, f32, atol 1e-6
unless stated."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import beamforming_lk_tpu.config as jcfg  # noqa: E402
from beamforming_lk_tpu.io import ring as jrg  # noqa: E402
from beamforming_lk_tpu.io import synthetic as jsyn  # noqa: E402
from beamforming_lk_tpu.models import mimo as jmm  # noqa: E402
from beamforming_lk_tpu.ops import antenna as jant  # noqa: E402
from beamforming_lk_tpu.ops import delay as jdl  # noqa: E402
from beamforming_lk_tpu.ops import geometry as jgeo  # noqa: E402
import beamforming_lk_tpu_torch.config as tcfg  # noqa: E402
from beamforming_lk_tpu_torch.io import ring as trg  # noqa: E402
from beamforming_lk_tpu_torch.io import synthetic as tsyn  # noqa: E402
from beamforming_lk_tpu_torch.models import mimo as tmm  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as tant  # noqa: E402
from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk  # noqa: E402
from beamforming_lk_tpu_torch.ops import delay as tdl  # noqa: E402
from beamforming_lk_tpu_torch.ops import geometry as tgeo  # noqa: E402

RNG = np.random.default_rng(0)
SPM = 48828.0 / 340.0


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["ArrayConfig", "DspConfig", "MimoConfig",
                                  "TrackerConfig", "TriangulationConfig",
                                  "PipelineConfig", "Config"])
def test_config_fields_match_jax_package(name):
    def fields(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING
                         else dataclasses.asdict(f.default_factory()))
                for f in dataclasses.fields(cls)}

    assert fields(getattr(tcfg, name)) == fields(getattr(jcfg, name))


def test_realtime_profile_matches_jax_package_except_kernel_and_chunk():
    """The port's profile is the JAX package's accelerator profile: off a
    TPU the JAX one keeps probe_kernel "xla" and fused_chunk 0, so those
    two fields are compared with the accelerator's values."""
    ours = tcfg.realtime(tcfg.Config())
    ref = jcfg.Config().realtime()     # off-TPU: probe_kernel xla, chunk 0
    for part in ("array", "dsp", "mimo", "tracker"):
        a = dataclasses.asdict(getattr(ours, part))
        b = dataclasses.asdict(getattr(ref, part))
        b.update({k: a[k] for k in ("probe_kernel", "fused_chunk") if k in b})
        assert a == b, part
    assert ours.tracker.probe_kernel == "pallas"
    assert ours.dsp.fused_chunk == 12


def _angles(n=50):
    theta = RNG.uniform(0.0, 1.57, n).astype(np.float32)
    phi = RNG.uniform(-7.0, 7.0, n).astype(np.float32)     # negative too
    spread = RNG.uniform(0.02, 0.2, n).astype(np.float32)
    return theta, phi, spread


def test_normalize_spherical_wraps_negative_phi():
    theta, phi, _ = _angles()
    theta = theta * 2.0 - 0.5
    got = tgeo.normalize_spherical(torch.tensor(theta), torch.tensor(phi), 1.2)
    want = jgeo.normalize_spherical(jnp.asarray(theta), jnp.asarray(phi), 1.2)
    for g, w in zip(got, want):
        _close(g, w, 2e-6)
    assert (got[1].numpy() >= 0).all()


def test_spherical_angle_and_edge_adjust():
    t1, p1, spread = _angles()
    t2, p2, _ = _angles()
    _close(tgeo.spherical_angle(*map(torch.tensor, (t1, p1, t2, p2))),
           jgeo.spherical_angle(*map(jnp.asarray, (t1, p1, t2, p2))), 2e-6)
    got = tgeo._edge_adjust(torch.tensor(t1), torch.tensor(spread))
    want = jgeo._edge_adjust(jnp.asarray(t1), jnp.asarray(spread))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("probes", ["quadrant_probes", "nearby_probes"])
def test_probe_generators(probes):
    theta, phi, spread = _angles()
    phi = np.mod(phi, 2 * np.pi)
    got = getattr(tgeo, probes)(*map(torch.tensor, (theta, phi, spread)))
    want = getattr(jgeo, probes)(*map(jnp.asarray, (theta, phi, spread)))
    _close(got[0], want[0], 1e-5)
    # Azimuth compared on the circle, weighted by sin(theta): at the pole it
    # is arbitrary.
    dphi = np.angle(np.exp(1j * (got[1].numpy() - np.asarray(want[1]))))
    assert np.abs(dphi * np.sin(np.asarray(want[0]))).max() < 1e-5
    _close(got[2], want[2])


@pytest.mark.parametrize("n_mics", [64, 256])
def test_antenna_layouts(n_mics):
    np.testing.assert_array_equal(tant.create_antenna_grid(8, 8, 0.02),
                                  jant.create_antenna_grid(8, 8, 0.02))
    np.testing.assert_array_equal(tant.multi_array_cluster(n_mics),
                                  jant.multi_array_cluster(n_mics))


def test_steering_delays():
    pts = tant.multi_array_cluster(256)
    theta, phi, _ = _angles()
    got = tant.steering_delays(pts, torch.tensor(theta), torch.tensor(phi), SPM)
    want = jant.steering_delays(jnp.asarray(pts), theta, phi, SPM)
    _close(got, want, 2e-5)                 # delays reach ~60 samples
    _close(tant.steering_delays_np(pts, theta, phi, SPM),
           jant.steering_delays_np(pts, theta, phi, SPM), 0)


@pytest.mark.parametrize("interp", ["linear", "fir"])
def test_probe_stencil_min_includes_masked_channels(interp):
    """The kernel's stencil (shift + taps, channel mask applied) equals the
    JAX dense stencil das_weights(steering_delays) * mask: the delay
    minimum runs over every channel, the masked one included (which is
    where the minimum sits for these directions)."""
    pts = tant.create_antenna_grid(8, 8, 0.02)
    mask = np.ones(64, np.float32)
    mask[0] = 0.0                           # corner mic: the min for phi ~ 0
    theta = np.full(8, 0.6, np.float32)
    phi = np.linspace(-0.3, 0.3, 8).astype(np.float32)
    taps = 2 if interp == "linear" else 8
    span = tdl.probe_span(pts, SPM, taps, 64)
    st = np.sin(theta)
    u = [torch.tensor(v) for v in (st * np.cos(phi), -st * np.sin(phi), np.cos(theta))]
    xyz = ctk.pack_geometry(pts, SPM, channel_mask=mask, device="cpu")
    shift, w = ctk._stencil(*u, xyz, span, taps, interp, 101,
                            ctk._consts("quadrant", taps, 1.0)["blackman"])
    dense = np.zeros((8, 64, span), np.float32)
    idx = shift.numpy()[..., None] + np.arange(taps)
    np.put_along_axis(dense, idx, w.numpy(), axis=-1)
    delays = jant.steering_delays(jnp.asarray(pts), theta, phi, SPM)
    bank = None if interp == "linear" else jdl.fractional_delay_fir_bank(101, 8)
    want = np.asarray(jdl.das_weights(delays, span, interp, bank)) * mask[:, None]
    _close(dense, want, 2e-6)


def test_probe_span_and_fir_bank():
    for n in (64, 256):
        pts = tant.multi_array_cluster(n)
        for taps in (2, 8):
            assert tdl.probe_span(pts, SPM, taps, 64) == jdl.probe_span(
                pts, SPM, taps, 64)
    np.testing.assert_array_equal(tdl.fractional_delay_fir_bank(),
                                  jdl.fractional_delay_fir_bank())


@pytest.mark.parametrize("interp", ["linear", "fir"])
def test_delay_lut_interp_and_weights(interp):
    delays = RNG.uniform(-1.0, 40.0, (6, 64)).astype(np.float32)
    taps = 2 if interp == "linear" else 8
    bank = None if interp == "linear" else jdl.fractional_delay_fir_bank(101, 8)
    gs, gf = tdl.delay_lut(torch.tensor(delays), 48, taps)
    ws, wf = jdl.delay_lut(jnp.asarray(delays), 48, taps)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    _close(gf, wf)
    _close(tdl.interp_weights(gf, interp, bank), jdl.interp_weights(wf, interp, bank))
    _close(tdl.das_weights(torch.tensor(delays), 48, interp, bank),
           jdl.das_weights(jnp.asarray(delays), 48, interp, bank))
    _close(tdl.das_weights_np(delays, 48, interp, bank),
           jdl.das_weights_np(delays, 48, interp, bank), 0)


def test_unfold_beam_bandpass_power():
    window = RNG.standard_normal((16, 48 + 64)).astype(np.float32)
    got_u = tdl.unfold_window(torch.tensor(window), 48, 64)
    want_u = jdl.unfold_window(jnp.asarray(window), 48, 64)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    w = RNG.standard_normal((5, 16, 48)).astype(np.float32)
    got_b = tdl.das_beam_unfolded(got_u, torch.tensor(w))
    want_b = jdl.das_beam_unfolded(want_u, jnp.asarray(w))
    _close(got_b, want_b, 1e-4)             # sums of 768 O(1) products
    _close(tdl.bandpass_ma(got_b), jdl.bandpass_ma(want_b), 1e-4)
    for bp in (True, False):
        want_p = np.asarray(jdl.das_power(want_b, use_bandpass=bp, divisor=640.0))
        _close(tdl.das_power(got_b, use_bandpass=bp, divisor=640.0), want_p,
               2e-6 * want_p.max())        # f32 sums of 64 squares, ~30


def test_ring_push_and_window():
    hist_t = trg.ring_init(8, 1024, device="cpu")
    hist_j = jrg.ring_init(8, 1024)
    for i in range(5):
        blk = RNG.standard_normal((8, 256)).astype(np.float32)
        hist_t = trg.ring_push(hist_t, torch.tensor(blk))
        hist_j = jrg.ring_push(hist_j, jnp.asarray(blk))
        np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))
        for taps in (2, 8):
            np.testing.assert_array_equal(
                trg.ring_window(hist_t, 256, 64, taps).numpy(),
                np.asarray(jrg.ring_window(hist_j, 256, 64, taps)))


def test_plane_wave_source():
    pts = tant.create_antenna_grid(8, 8, 0.02)
    src = [(0.5, 1.2, 5000.0), (0.9, 4.0, 3000.0, 0.5)]
    got = tsyn.plane_wave_block(pts, src, 512, 256)
    want = jsyn.plane_wave_block(pts, src, 512, 256)
    _close(got, want, 1e-7)                 # f64 vs f32 steering delays


def test_mimo_grid_and_render():
    cfg = tcfg.MimoConfig(rows=16, columns=16)
    for g, w in zip(tmm.make_mimo_grid(cfg), jmm.make_mimo_grid(cfg)):
        np.testing.assert_array_equal(g, w)
    power = RNG.uniform(0.0, 2.0, 256).astype(np.float32)
    for use_db in (False, True):
        gi, gp = tmm.render_heatmap(torch.tensor(power), 16, 16,
                                    torch.tensor(1.5), use_db=use_db)
        wi, wp = jmm.render_heatmap(jnp.asarray(power), 16, 16,
                                    jnp.float32(1.5), use_db=use_db)
        assert np.abs(gi.numpy().astype(int) - np.asarray(wi).astype(int)).max() <= 1
        _close(gp, wp)


# The JAX package's last public helpers.

def _dirs(n=40):
    return (RNG.uniform(0.0, np.pi / 2, n).astype(np.float32),
            RNG.uniform(-np.pi, 2 * np.pi, n).astype(np.float32))


def test_geometry_helpers():
    """smallest_angle, cartesian_to_spherical, horizontal_to_spherical and
    spherical_chord_distance against the JAX package's."""
    (t1, p1), (t2, p2) = _dirs(), _dirs()
    _close(tgeo.smallest_angle(torch.as_tensor(p1), torch.as_tensor(p2)),
           jgeo.smallest_angle(p1, p2))
    xyz = RNG.normal(size=(40, 3)).astype(np.float32)
    for got, want in zip(tgeo.cartesian_to_spherical(torch.as_tensor(xyz)),
                         jgeo.cartesian_to_spherical(jnp.asarray(xyz))):
        _close(got, want, atol=2e-6)
    for got, want in zip(tgeo.horizontal_to_spherical(torch.as_tensor(p1),
                                                      torch.as_tensor(t1)),
                         jgeo.horizontal_to_spherical(p1, t1)):
        _close(got, want, atol=2e-6)
    _close(tgeo.spherical_chord_distance(*map(torch.as_tensor, (t1, p1, t2, p2))),
           jgeo.spherical_chord_distance(t1, p1, t2, p2), atol=2e-6)
    _close(tgeo.spherical_to_cartesian(torch.as_tensor(t1), torch.as_tensor(p1), 2.5),
           jgeo.spherical_to_cartesian(t1, p1, 2.5))


def test_quadrant_probes_reference():
    """The reference's mirrored probe construction, port vs JAX."""
    theta, phi = _dirs(16)
    for got, want in zip(
            tgeo.quadrant_probes_reference(torch.as_tensor(theta),
                                           torch.as_tensor(phi), 0.1),
            jgeo.quadrant_probes_reference(theta, phi, 0.1)):
        _close(got, want, atol=5e-6)


def test_antenna_helpers():
    """sector_masks, steer_points and the horizontal / Cartesian steering
    delays against the JAX package's."""
    np.testing.assert_array_equal(tant.sector_masks(), jant.sector_masks())
    pts = tant.multi_array_cluster(256)
    theta, phi = _dirs(12)
    _close(tant.steer_points(pts, torch.as_tensor(theta), torch.as_tensor(phi)),
           jant.steer_points(pts, theta, phi))
    _close(tant.steering_delays_horizontal(pts, phi, theta, SPM),
           jant.steering_delays_horizontal(pts, phi, theta, SPM), atol=2e-4)
    xyz = RNG.normal(size=(12, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
    _close(tant.steering_delays_cartesian(pts, xyz, SPM),
           jant.steering_delays_cartesian(pts, xyz, SPM), atol=2e-4)


def test_dome_lookup_is_the_jax_packages():
    """The Fibonacci dome, its degree lookup table and its worst error,
    bitwise (numpy copies)."""
    dome = tant.generate_unit_dome(500)
    np.testing.assert_array_equal(dome, jant.generate_unit_dome(500))
    table = tant.generate_dome_lookup(dome)
    np.testing.assert_array_equal(table, jant.generate_dome_lookup(dome))
    assert tant.dome_lookup_max_error(dome, table) == jant.dome_lookup_max_error(dome, table)
    assert tant.dome_lookup_max_error(dome, table) < 0.2


@pytest.mark.parametrize("interp", ["linear", "fir"])
def test_dense_das_beam_and_power_from_delays(interp):
    """The dense-stencil ``das_beam`` and ``das_power_from_delays`` (with
    and without a channel mask) against the JAX package's, within 1e-5 of
    the largest value."""
    pts = tant.create_antenna_grid()
    theta, phi = _dirs(24)
    delays = tant.steering_delays_np(pts, theta, phi, SPM)
    window = RNG.normal(size=(64, 256 + 64)).astype(np.float32)
    bank = None if interp == "linear" else jdl.fractional_delay_fir_bank(101, 8)
    w = jdl.das_weights_np(delays, 64, interp, bank)
    want = np.asarray(jdl.das_beam(jnp.asarray(window), jnp.asarray(w)))
    got = tdl.das_beam(torch.as_tensor(window), torch.as_tensor(w)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    mask = np.ones(64, np.float32)
    mask[5] = 0.0
    for m in (None, mask):
        want = np.asarray(jdl.das_power_from_delays(
            jnp.asarray(window), jnp.asarray(delays), shift_range=64, mode=interp,
            fir_bank=bank, channel_mask=m))
        got = tdl.das_power_from_delays(
            torch.as_tensor(window), torch.as_tensor(delays), shift_range=64,
            mode=interp, fir_bank=bank, channel_mask=m).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * want.max())


def test_step_builders_match_the_jax_packages():
    """``make_swarm_step`` and ``make_miso_step`` build the port's step
    modules on the CPU with the JAX package's probe span; one MISO step
    from boresight agrees with the JAX one within 1e-5 rad."""
    from beamforming_lk_tpu.models import miso as jms
    from beamforming_lk_tpu_torch.models import miso as tms
    from beamforming_lk_tpu_torch.models import tracker as ttk

    cfg = tcfg.Config()
    pts = tant.create_antenna_grid()
    swarm = ttk.make_swarm_step(pts, cfg.tracker, cfg.dsp, cfg.array, device="cpu")
    miso = tms.make_miso_step(pts, cfg.tracker, cfg.dsp, cfg.array, device="cpu")
    assert isinstance(swarm, ttk.SwarmStep) and isinstance(miso, tms.MisoStep)
    assert swarm.span == miso.probes.span == jdl.probe_span(
        pts, cfg.array.samples_per_meter, 2, cfg.dsp.shift_range)
    hist = trg.ring_init(64, cfg.dsp.history, device="cpu")
    block = tsyn.plane_wave_block(pts, [(0.3, 1.0, 5000.0)], 0, 256, noise_std=0.02)
    window = trg.ring_window(trg.ring_push(hist, torch.as_tensor(block)),
                             256, cfg.dsp.shift_range, 2)
    state, beam = miso(tms.miso_init(device="cpu"), window)
    jc = jcfg.Config()
    jstep = jms.make_miso_step(pts, jc.tracker, jc.dsp, jc.array)
    jstate, jbeam = jstep(jms.miso_init(), jnp.asarray(window.numpy()))
    _close(state.particle.theta, jstate.particle.theta, atol=1e-5)
    assert np.abs(beam.numpy() - np.asarray(jbeam)).max() <= 1e-4 * np.abs(jbeam).max()
