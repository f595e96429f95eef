"""The swarm's random draws, made again from the seed in the order that
``AwpuPipeline`` documents for its own generator
(``beamforming_lk_tpu_torch/app/awpu.py`` and ``models/tracker.py``):

- ``torch.Generator(device).manual_seed(seed)``;
- the first seekers: ``rand((2, Ns))``;
- then for each block ``k`` from 0: where ``k`` is a reset block
  (``k % seeker_reset_interval == 0``) the seekers' reset ``rand((2, Ns))``,
  then the jumps ``rand((2, I, Ns))``; the per-block and the chunked
  replay draw alike.

A reset draw ``u`` places a seeker at (``u[0] * theta_limit``,
``u[1] * 2 pi``), a jump draw is ``(2 u - 1) * theta_limit / 2``
(``particle.cpp:11-14``, ``gradient_ascend.cpp``'s jumps).  The program
draws on the card, so the benchmark hands it no draws: the reference
makes the same ones on the same kind of device.
"""

from __future__ import annotations

import math

import torch


class SwarmDraws:
    """The draws of the blocks a check needs, each ``(reset_theta [Ns] or
    None, reset_phi [Ns] or None, jump_theta [I, Ns], jump_phi [I, Ns])``."""

    def __init__(self, seed: int, tracker: dict, device):
        self.seed = int(seed) % (2 ** 63)
        self.ns, self.it = tracker["n_seekers"], tracker["iterations"]
        self.interval = tracker["seeker_reset_interval"]
        self.limit = math.radians(tracker["fov_degrees"] / 2.0)
        self.device = torch.device(device)

    def of_blocks(self, blocks) -> dict:
        """``{k: draws of block k}`` for every ``k`` in ``blocks``,
        replaying the generator from the pipeline's start."""
        need = set(int(k) for k in blocks)
        out = {}
        if not need:
            return out
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        dev, ns = self.device, self.ns
        torch.rand((2, ns), generator=gen, device=dev)          # first seekers
        for k in range(max(need) + 1):
            reset = (torch.rand((2, ns), generator=gen, device=dev)
                     if k % self.interval == 0 else None)
            jumps = torch.rand((2, self.it, ns), generator=gen, device=dev)
            if k in need:
                rt = rp = None
                if reset is not None:
                    rt, rp = reset[0] * self.limit, reset[1] * (2.0 * math.pi)
                j = (jumps * 2.0 - 1.0) * (self.limit / 2.0)
                out[k] = (rt, rp, j[0], j[1])
        return out
