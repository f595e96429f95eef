"""The import guard, and a run's refusals: no card, or a checkout that holds
the benchmark alone."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import run


@pytest.mark.parametrize("modules, found", [
    (["beamforming_lk_tpu_torch", "beamforming_lk_tpu_torch.ops.cuda_tracker",
      "torch", "numpy"], []),
    (["beamforming_lk_tpu", "torch"], ["beamforming_lk_tpu"]),
    (["beamforming_lk_tpu.ops.delay"], ["beamforming_lk_tpu"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "beamforming_lk_tpu_torch_extra"], []),
])
def test_guard_compares_whole_top_level_names(modules, found):
    assert run.forbidden_modules(modules) == found


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import portbench.run as r, "
            "portbench.check, portbench.traffic, portbench.trace, "
            "beamforming_lk_tpu_torch.app; print(r.forbidden_modules())" % str(run.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def _run(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _json_lines(text):
    lines = []
    for line in text.splitlines():
        try:
            lines.append(json.loads(line))
        except ValueError:
            pass
    return lines


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    import torch

    args = ("--workload", "lk256-rt-live", "--seed", "5", "--seconds", "1",
            "--trace", "0")
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(run.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    alone = _run(tmp_path, *args)
    assert alone.returncode != 0 and not _json_lines(alone.stdout)
    if not torch.cuda.is_available():
        here = _run(run.ROOT, *args)
        assert here.returncode != 0 and not _json_lines(here.stdout)
        assert "CUDA" in here.stderr
