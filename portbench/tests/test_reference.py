"""The comparison that decides ``correct``, on the CPU at a tiny size:
the program's window equals the plain reference; the control (the
program's own bfloat16 volume) reads above the program on every number;
and each fault the cell can have, planted under a run, fails the limits.
"""

import time

import pytest
import torch

import run as runmod
from harness import spec

DEV = torch.device("cpu")


@pytest.fixture(scope="module")
def drv():
    return spec.driver("orbit")


@pytest.fixture(scope="module")
def inputs(drv, vga_cell):
    return drv.make_inputs(vga_cell.config, vga_cell.traffic, 2**31 + 77, DEV)


def _numbers(drv, cell, inputs, prog, seconds=0.1):
    win = drv.run_window(prog, inputs, seconds, 0.001, False)
    return drv.check(prog, inputs, win, 77, 0.001)[0], win


@pytest.fixture(scope="module")
def program_numbers(drv, vga_cell):
    """A whole sound run (set-up, window, check) on the CPU."""
    torch.set_num_threads(4)
    return drv.run(vga_cell, 2**31 + 77, 0.1, False, time.time(), device="cpu").numbers


def test_program_equals_reference(program_numbers, vga_cell):
    assert set(program_numbers) == set(vga_cell.limits["numbers"])
    assert all(v == 0.0 for v in program_numbers.values()), program_numbers
    assert runmod.checks_of(program_numbers, vga_cell.limits["numbers"])[0]


def test_control_reads_above_the_program_on_every_number(drv, vga_cell, inputs,
                                                         program_numbers):
    ctl, _ = _numbers(drv, vga_cell, inputs, drv.Program(vga_cell.config, DEV, torch.bfloat16))
    for name, val in ctl.items():
        assert val > 3 * program_numbers[name], (name, val)


class Frozen:
    """A step that returns its state unchanged (the volume, updated in
    place, still moves)."""

    def wrap(self, out, state, depth):
        return state._replace(frame_index=out.frame_index)


class Altered:
    """An answer altered where it is produced: one frame's pose moved 2 mm."""

    def wrap(self, out, state, depth):
        if int(out.frame_index) != 3:
            return out
        pose = out.pose.clone()
        pose[3, 0] += 0.002
        return out._replace(pose=pose)


class HalfFrame:
    """Half of the batch left out: the lower half of each frame's rows."""

    def depth(self, depth):
        d = depth.clone()
        d[d.shape[0] // 2:] = 0.0
        return d


@pytest.mark.parametrize("fault", [Frozen(), Altered(), HalfFrame()],
                         ids=["state_unchanged", "answer_altered", "half_left_out"])
def test_a_planted_fault_is_not_correct(drv, vga_cell, monkeypatch, fault):
    """A whole run (set-up, window, check, result line) past the look for
    a card, with the fault planted under the timed step."""
    step = drv.Program.__call__

    def broken(self, state, depth):
        if hasattr(fault, "depth"):
            depth = fault.depth(depth)
        out = step(self, state, depth)
        return fault.wrap(out, state, depth) if hasattr(fault, "wrap") else out

    monkeypatch.setattr(drv.Program, "__call__", broken)
    res = drv.run(vga_cell, 2**31 + 78, 0.1, False, time.time(), device="cpu")
    correct, checks = runmod.checks_of(res.numbers, vga_cell.limits["numbers"])
    line = runmod.result_line(res, {}, {}, None, checks, correct)
    assert line["correct"] is False, res.numbers


def test_other_passes_are_held_to_the_last(drv, vga_cell, inputs):
    """A window of several passes: identical passes are counted as such;
    a pass whose poses differ is replayed and compared too."""

    win = drv.run_window(drv.Program(vga_cell.config, DEV), inputs, 6.0, 0.001, False)
    nums, replayed, identical = drv.check(drv.Program(vga_cell.config, DEV), inputs, win, 77,
                                          0.001)
    assert win.passes >= 2 and identical == win.passes - 1 and replayed == 1
    assert nums["pose_gap_mm"] == 0.0
    poses = win.poses.clone()
    poses[1, 3, 1] += 0.003
    win.poses = poses
    nums, replayed, identical = drv.check(drv.Program(vga_cell.config, DEV), inputs, win, 77,
                                          0.001)
    assert replayed == 2 and identical == win.passes - 2
    assert nums["pose_gap_mm"] == pytest.approx(3.0, rel=1e-3)
