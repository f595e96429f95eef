"""Cells cut to a size the CPU runs in seconds (64 mics, a short pool),
for the benchmark's own tests."""

from portbench import run


def small_cell(workload: str, channels: int = 64, root=run.ROOT) -> dict:
    spec = run.load_cell(workload, root=root)
    t = spec["traffic"]
    spec["config"] = dict(spec["config"], channels=channels)
    spec["traffic"] = dict(t, pool_blocks=96, verify_calls=2, warmup_seconds=0.0,
                           warmup_blocks=12 if t["batch"] == 1 else 24)
    return spec


SECONDS = {"lk256-rt-live": 0.05, "lk256-rt-replay": 0.2, "lk64-default-stream": 0.1,
           "lk64-rt-live": 0.05}
