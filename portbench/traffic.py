"""The one traffic generator: a pool of array blocks made from ``--seed``
on the device, held in host memory, fed in order.

A traffic file (``portbench/traffic/<name>.json``) gives:

- ``sources``: plane waves, each ``{"theta", "phi", "frequency_hz",
  "relative_amplitude", "phi_rate_deg_s"}`` (a source moving in phi at a
  constant rate); ``amplitude`` (of a unit source) and ``noise`` (white
  Gaussian noise's standard deviation, as a share of ``amplitude``);
- ``pool_blocks``: blocks made in set-up; block ``k`` of the stream is
  pool block ``k % pool_blocks``, so a run longer than the pool wraps to
  its start (a source moving in phi at 10 deg/s turns once in 6866
  blocks, so it wraps to within 0.03 deg of where it was);
- ``loop``: ``"paced"`` (one block due every ``1 / rate_hz`` s, an open
  loop) or ``"closed"`` (the next call as soon as the last one's outputs
  are on the host);
- ``batch``: blocks a call (1 through ``process_block``, more through
  ``process_blocks``); ``rate_hz`` for a paced loop; ``warmup_blocks``
  (back to back, the cell's shapes) and ``warmup_seconds`` (the window's
  own loop) before the window; ``verify_calls``, the calls of the window
  that ``correct`` checks.

Channel ``c`` of a source from direction (theta, phi) carries
``a sin(2 pi f (n + tau_c) / fs)``, ``tau_c`` its steering delay in
samples (the signal of ``beamforming_lk_tpu_torch/io/synthetic.py``'s
``plane_wave_block`` and ``chip_smoke.py``'s ``_plane_wave_blocks``,
written again in torch so that it runs on the device).  The swarm's draws
are the pipeline's own, from its generator seeded with ``--seed``
(:mod:`portbench.reference.draws` makes them again).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import geometry as geo

_BLOCKS_A_CALL = 64      # blocks made by one set of device calls


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 2654435761 + stream) % (2 ** 63))


class Traffic:
    """The pool of one run: ``blocks`` [N, C, T] f32 in (pinned) host
    memory."""

    def __init__(self, traffic: dict, cfg: dict, seed: int, device):
        a, d = cfg["array"], cfg["dsp"]
        self.spec = traffic
        n, c, tl = traffic["pool_blocks"], cfg["channels"], d["block_size"]
        self.n_blocks, self.block_size = n, tl
        self.points = geo.array_points(c, a["columns"], a["rows"], a["distance"])
        pinned = torch.device(device).type == "cuda"
        self.blocks = torch.empty((n, c, tl), dtype=torch.float32,
                                  pin_memory=pinned)
        gen = _generator(seed, 0, device)
        for b0 in range(0, n, _BLOCKS_A_CALL):
            nb = min(_BLOCKS_A_CALL, n - b0)
            self.blocks[b0:b0 + nb].copy_(
                self._signal(b0, nb, cfg, gen, device))

    def _signal(self, b0: int, nb: int, cfg: dict, gen, device):
        """Blocks ``b0 .. b0+nb`` [nb, C, T] f32 on ``device``."""
        a, tl = cfg["array"], cfg["dsp"]["block_size"]
        fs, spm = a["sample_rate"], a["sample_rate"] / a["propagation_speed"]
        spec = self.spec
        p = torch.as_tensor(self.points, dtype=torch.float64, device=device)
        n = torch.arange(b0 * tl, (b0 + nb) * tl, dtype=torch.float64,
                         device=device)                           # [S]
        x = torch.zeros((p.shape[1], n.shape[0]), dtype=torch.float64,
                        device=device)
        for src in spec["sources"]:
            th = src["theta"]
            ph = src["phi"] + math.radians(src.get("phi_rate_deg_s", 0.0)) * n / fs
            u = torch.stack([math.sin(th) * torch.cos(ph),
                             -math.sin(th) * torch.sin(ph),
                             torch.full_like(ph, math.cos(th))])  # [3, S]
            tau = (p.T @ u) * spm                                 # [C, S]
            tau = tau - tau.amin(dim=0, keepdim=True)
            f = src["frequency_hz"]
            cycles = torch.remainder(f * (n + tau) / fs, 1.0)
            x += src.get("relative_amplitude", 1.0) * torch.sin(2.0 * math.pi * cycles)
        amp = spec["amplitude"]
        x = (x * amp).to(torch.float32)
        x += torch.randn(x.shape, generator=gen, device=device) * (spec["noise"] * amp)
        return x.reshape(p.shape[1], nb, tl).permute(1, 0, 2)

    # -- the stream -------------------------------------------------------

    def batch(self, k: int, m: int):
        """Stream blocks ``k .. k+m`` ([m, C, T], host memory)."""
        i = k % self.n_blocks
        if i + m > self.n_blocks:
            return self.blocks[[(k + j) % self.n_blocks for j in range(m)]]
        return self.blocks[i:i + m]

    def block(self, k: int):
        """Stream block ``k`` ([C, T], host memory)."""
        return self.blocks[k % self.n_blocks]

    def samples(self, start: int, stop: int, history: int, device):
        """Samples ``start .. stop`` [C, stop-start] f32 of the stream with
        ``history`` zeros before its first block (the ring's state before
        block 0), on ``device``: sample ``history + j`` is sample ``j`` of
        the stream."""
        tl = self.block_size
        out = torch.zeros((self.blocks.shape[1], stop - start), dtype=torch.float32)
        s0 = max(start, history)
        if stop > s0:
            first, last = (s0 - history) // tl, (stop - 1 - history) // tl
            idx = [b % self.n_blocks for b in range(first, last + 1)]
            seg = self.blocks[idx].permute(1, 0, 2).reshape(self.blocks.shape[1], -1)
            off = s0 - history - first * tl
            out[:, s0 - start:] = seg[:, off:off + stop - s0]
        return out.to(device)
