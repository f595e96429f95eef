"""A run with the timed path broken underneath must come out not correct:
the harness is driven past its look for a card (on the CPU, at 64 mics),
the pipeline's entry wrapped to plant each fault a cell can have.  The
control (the reference one precision lower, in the program's place) must
fail the same limits; on a card, at the cell's own size, on three seeds."""

import pytest
import torch

from portbench import check, run
from portbench.tests.portbench_cells import SECONDS, small_cell

CELLS = tuple(SECONDS)


def _state_unchanged(pipe):
    """The entry returns its outputs but leaves the carried state as it was."""
    for name in ("process_block", "process_blocks"):
        entry = getattr(pipe, name)

        def frozen(blocks, draws=None, entry=entry):
            state = pipe.state
            out = entry(blocks, draws=draws)
            pipe.state = state
            return out

        setattr(pipe, name, frozen)


def _half_batch(pipe):
    """The second half of a batch is left out: its first half stands in."""
    entry = pipe.process_blocks

    def half(blocks, draws=None):
        blocks = torch.as_tensor(blocks).clone()
        m = blocks.shape[0] // 2
        blocks[m:2 * m] = blocks[:m]
        return entry(blocks, draws=draws)

    pipe.process_blocks = half


def _answer_altered(pipe):
    """Each published target's direction is moved where it is produced."""
    for name in ("process_block", "process_blocks"):
        entry = getattr(pipe, name)

        def moved(blocks, draws=None, entry=entry):
            out = entry(blocks, draws=draws)
            tg = out.targets._replace(theta=out.targets.theta + 0.01)
            return out._replace(targets=tg)

        setattr(pipe, name, moved)


def _later_blocks_altered(pipe):
    """Each published target's direction is moved on every block of a
    chunk but the first, where the chunk's kernel produces it."""
    entry = pipe.process_blocks

    def moved(blocks, draws=None):
        out = entry(blocks, draws=draws)
        theta = out.targets.theta.clone()
        theta[1:] += 0.01
        return out._replace(targets=out.targets._replace(theta=theta))

    pipe.process_blocks = moved


def _map_altered(pipe):
    """The heatmap is scaled by 1.05 where it is produced."""
    for name in ("process_block", "process_blocks"):
        entry = getattr(pipe, name)

        def scaled(blocks, draws=None, entry=entry):
            out = entry(blocks, draws=draws)
            return out._replace(powers=out.powers * 1.05)

        setattr(pipe, name, scaled)


FAULTS = {"state_unchanged": _state_unchanged, "answer_altered": _answer_altered,
          "map_altered": _map_altered, "half_batch": _half_batch,
          "later_blocks_altered": _later_blocks_altered}
#: Faults that only a call of more than one block can have.
CHUNKED = ("half_batch", "later_blocks_altered")


def _cases():
    for w in CELLS:
        for f in FAULTS:
            if f in CHUNKED and not w.endswith("replay"):
                continue       # one block a call: no half, no later block
            yield w, f


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct_at_the_test_size(workload):
    result, shown = run.run_cell(small_cell(workload), 2 ** 31 + 3, SECONDS[workload],
                                 False, device="cpu")
    assert result["correct"], shown


@pytest.mark.parametrize("workload, fault", list(_cases()))
def test_a_planted_fault_is_not_correct(workload, fault):
    result, shown = run.run_cell(small_cell(workload), 2 ** 31 + 3, SECONDS[workload],
                                 False, device="cpu", pipeline_hook=FAULTS[fault])
    assert not result["correct"], shown


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits(workload):
    spec = small_cell(workload)
    result, _ = run.run_cell(spec, 2 ** 31 + 5, SECONDS[workload], False,
                             device="cpu", control=True)
    ok, shown = check.verdict(result["control"], spec["limits"])
    assert not ok, shown


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_on_the_card_at_the_cells_size(card, workload):
    spec = run.load_cell(workload)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        result, shown = run.run_cell(spec, seed, 2.0, False, device=card, control=True)
        assert result["correct"], shown
        assert not check.verdict(result["control"], spec["limits"])[0], result["control"]
