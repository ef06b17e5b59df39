"""The check catches a broken program: each run below drives the rest of a
cell's run on the CPU at the tiny size (the look for a card skipped), with
the timed path broken underneath, and `correct` must come out false; the
same run unbroken comes out true. The faults a generation cell can have:
the denoiser's step returns its state unchanged; half of the batch left out
(its clips are the other half's); one answer altered where it is produced
(the first clip of every call, reversed in time). A single card exchanges
nothing, so no cell here can leave an exchange out; gen-b1's batch of one
has no half to leave out."""

import pytest
import torch

from benchmark.tests.common import tiny_run

CELLS = ["gen-b32", "teacher-b8", "gen-b1"]


def unchanged_state(monkeypatch):
    from consistencytta_torch.models.pipeline import Pipeline

    monkeypatch.setattr(Pipeline, "query_student", lambda self, z, *a, **k: z)
    monkeypatch.setattr(Pipeline, "query_teacher_cfg", lambda self, z, *a, **k: z)


def half_batch(monkeypatch):
    from consistencytta_torch.models.pipeline import Pipeline

    decode = Pipeline.decode_latents

    def first_half(self, z, *a, **k):
        half = decode(self, z[: z.shape[0] // 2], *a, **k)
        return torch.cat([half, half])

    monkeypatch.setattr(Pipeline, "decode_latents", first_half)


def altered_answer(monkeypatch):
    from consistencytta_torch.models.pipeline import Pipeline

    decode = Pipeline.decode_latents

    def altered(self, z, *a, **k):
        wav = decode(self, z, *a, **k)
        wav[0] = wav[0].flip(-1)
        return wav

    monkeypatch.setattr(Pipeline, "decode_latents", altered)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = tiny_run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 1


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    if fault == "half_batch" and cell == "gen-b1":
        pytest.skip("a batch of one has no half to leave out")
    FAULTS[fault](monkeypatch)
    r = tiny_run(cell)
    assert not r["correct"], r["checks"]
