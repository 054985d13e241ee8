"""The comparison fails what it has to fail: the controls, and the program
broken underneath the timed path, each run through the whole harness on
the CPU at a tiny size (the look for a card skipped)."""

import pytest

from conftest import run_tiny


def _patch_store(monkeypatch, fault):
    from repro_torch import index as ix
    from repro_torch.store import store as st
    if fault == "answer":                    # a count or a bit count
        orig, orig_b = ix.execute_card, ix.batched_and_card
        monkeypatch.setattr(ix, "execute_card",
                            lambda *a, **k: orig(*a, **k) + 1)

        def off_by_one(stack, rows):
            out = orig_b(stack, rows).clone()
            out[0] += 1
            return out
        monkeypatch.setattr(ix, "batched_and_card", off_by_one)
    elif fault == "state_unchanged":         # the first answer, always
        orig, first = st.BitmapStore.count, {}
        monkeypatch.setattr(
            st.BitmapStore, "count", lambda self, p, **k: first.setdefault(
                "v", orig(self, p, **k)))
    elif fault == "half_batch":              # half the bit slices left out
        orig = ix.batched_and_card

        def half(stack, rows):
            out = orig(stack, rows).clone()
            out[out.shape[0] // 2:] = 0
            return out
        monkeypatch.setattr(ix, "batched_and_card", half)


@pytest.mark.parametrize("cell", ["t-count", "t-revenue"])
def test_sound_program_is_correct(tiny_root, cell):
    line, checks = run_tiny(tiny_root, cell)
    assert line["correct"], checks
    assert line["answers"]["checked"] > 0


@pytest.mark.parametrize("cell", ["t-count", "t-revenue"])
def test_control_is_not_correct(tiny_root, cell):
    from portbench.control import control_for
    line, checks = run_tiny(tiny_root, cell,
                            server=control_for(tiny_root, cell))
    assert not line["correct"], checks
    assert line["checks"]["wrong"]["value"] > 0


@pytest.mark.parametrize("cell, fault", [
    ("t-count", "answer"), ("t-count", "state_unchanged"),
    ("t-revenue", "answer"), ("t-revenue", "half_batch")])
def test_broken_program_is_not_correct(tiny_root, monkeypatch, cell, fault):
    _patch_store(monkeypatch, fault)
    line, checks = run_tiny(tiny_root, cell)
    assert not line["correct"], checks
