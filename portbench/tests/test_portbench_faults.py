"""The judge fails what it must. A run drives the whole harness with a
stand-in under the timed path and sees ``correct`` come out false: the
control (the reference in TF32 in the program's place), and each planted
fault the cells can have (a step that returns its state unchanged, half
of each answer left out, an answer altered where it is produced). The
program itself comes out correct. On the CPU at small sizes; the card's
tests run the control and the faults at the cells' own sizes."""
import pytest

from portbench import run, spec
from portbench.control import FAULTS, Control

CELLS = ["still8k.host", "video_hd.device"]
SEED = 2 ** 31 + 4242


def one_run(root, name, make, seconds=0.5):
    cell = spec.load_cell(name, root)
    result, lines = run.run_cell(cell, SEED, seconds, False, device="cpu",
                                 make_coders=make)
    assert lines[-1].startswith("check dec_worst_miss")
    assert list(result)[-1] == "checks"
    return result


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(small_root, name):
    res = one_run(small_root, name, None)
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in spec.load_cell(
        name, small_root).end_to_end}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_fault_is_not_correct(small_root, name, kind):
    res = one_run(small_root, name, FAULTS[kind])
    assert not res["correct"]
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert over, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(small_root, name):
    res = one_run(small_root, name, Control, seconds=1.0)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.card
@pytest.mark.parametrize("name", ["still8k.host", "video_hd.device"])
def test_control_at_cell_size(card, name):
    """The control on the card at the cell's own size, three seeds."""
    run.use_cache_dirs()
    cell = spec.load_cell(name)
    for k in range(3):
        res, _ = run.run_cell(cell, SEED + k, 4.0, False, make_coders=Control)
        assert not res["correct"]


@pytest.mark.card
@pytest.mark.parametrize("name", ["still8k.host", "video_hd.device"])
@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_fault_at_cell_size(card, name, kind):
    """Each planted fault on the card at the cell's own size."""
    run.use_cache_dirs()
    cell = spec.load_cell(name)
    res, _ = run.run_cell(cell, SEED, 2.0, False, make_coders=FAULTS[kind])
    assert not res["correct"]
