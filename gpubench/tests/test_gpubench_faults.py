"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
(`run.measure`, `run.check`) on the CPU, where the program runs its plain
twins, at tiny copies of each cell: the sound program passes; the control
(the reference in bfloat16 in the program's place) fails; and so does each
fault the cells can have: a Lloyd step that returns its state unchanged,
half of the pixels left out of the mean, and an answer altered where it
is produced. A cell on one card has no exchange between cards to leave
out."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench import judge, run
from gpubench.tests._cells import TINY, tiny_cell

CPU = torch.device("cpu")
CELLS = sorted(TINY)


def drive(name, seed=2**31 + 5):
    cell = tiny_cell(name)
    r, pool, sample, failed, _ = run.measure(cell, seed, 0.2, False, CPU)
    correct, checks, values = run.check(cell, pool, sample, CPU)
    return correct and failed == 0, values


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    correct, values = drive(name)
    assert correct and values["pixels_differing"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    r, pool, sample, failed, _ = run.measure(cell, 11, 0.2, False, CPU)
    # The control's output in the program's place, judged by the float32 reference.
    from gpubench import reference

    call = reference.CALLS[cell.traffic["call"]]
    tms = cell.processor_options()["train_max_size"]
    pairs = []
    for _, j, outputs in sample.kept:
        low = call(pool[j], cell.traffic["colors"], cell.traffic["mode"], tms, CPU, lowp=True)
        pairs.extend(zip(low.reshape(-1, *outputs[0].shape).numpy(), outputs))
    correct, _ = judge.verdict(judge.numbers(pairs), cell.limits)
    assert not correct


def _unchanged_step(monkeypatch):
    from kmeans_tpu_torch.models import kmeans

    monkeypatch.setattr(kmeans, "_lloyd_loop", lambda cents, *a, **k: (cents, 1))
    monkeypatch.setattr(kmeans, "lloyd_batched", lambda px, cents, *a, **k: (
        cents, torch.ones(cents.shape[0], dtype=torch.int64)))


def _half_the_pixels(monkeypatch):
    from kmeans_tpu_torch.models import kmeans

    whole = kmeans._update_centroids

    def half(pixels, assign, k, weight=None):
        n = pixels.shape[0] // 2
        return whole(pixels[:n], assign[:n], k, None if weight is None else weight[:n])

    monkeypatch.setattr(kmeans, "_update_centroids", half)


def _alter_output_pass(monkeypatch, alter):
    from kmeans_tpu_torch import api

    def altered(fn):
        def wrapper(*args, **kwargs):
            return alter(fn(*args, **kwargs).clone())
        return wrapper

    monkeypatch.setattr(api, "assign_packed", altered(api.assign_packed))
    monkeypatch.setattr(api, "assign_frames_packed", altered(api.assign_frames_packed))


def _altered_answer(monkeypatch):
    """Each call's packed indices moved one word along: every pixel of the
    answer takes the indices of its neighbours'."""
    _alter_output_pass(monkeypatch, lambda words: torch.roll(words.reshape(-1), 1).reshape(
        words.shape))


def _one_index_altered(monkeypatch):
    """The lowest bit of the first packed word flipped: one pixel's index."""
    def flip(words):
        words.view(-1)[0] ^= 1
        return words
    _alter_output_pass(monkeypatch, flip)


EXACT = [n for n in CELLS if tiny_cell(n).limits["compare"].get("pixels_differing") == 0]


@pytest.mark.parametrize("name", EXACT)
def test_one_index_altered_is_not_correct(name, monkeypatch):
    _one_index_altered(monkeypatch)
    correct, values = drive(name)
    assert not correct and values["pixels_differing"] >= 1


@pytest.mark.parametrize("fault", [_unchanged_step, _half_the_pixels, _altered_answer],
                         ids=["unchanged_step", "half_the_pixels", "altered_answer"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    correct, values = drive(name)
    assert not correct and values["pixels_differing"] > 0


def test_outputs_kept_are_their_own_arrays():
    cell = tiny_cell("gif1080p-16f-k256-dither")
    cell.limits = {**cell.limits, "sample_calls": 3}
    r, pool, sample, failed, _ = run.measure(cell, 3, 0.3, False, CPU)
    assert len(r.calls) > len(sample.kept) == 3
    kept = [outputs[0] for _, _, outputs in sample.kept]
    assert not any(np.shares_memory(a, b) for i, a in enumerate(kept) for b in kept[i + 1:])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card_sound_and_control(name, cuda_device):
    cell = tiny_cell(name)
    r, pool, sample, failed, _ = run.measure(cell, 2**31 + 9, 0.5, True, cuda_device)
    correct, checks, values = run.check(cell, pool, sample, cuda_device)
    assert correct and failed == 0, values
    from gpubench import reference

    call = reference.CALLS[cell.traffic["call"]]
    tms = cell.processor_options()["train_max_size"]
    pairs = []
    for _, j, outputs in sample.kept:
        low = call(pool[j], cell.traffic["colors"], cell.traffic["mode"], tms, cuda_device,
                   lowp=True)
        pairs.extend(zip(low.reshape(-1, *outputs[0].shape).cpu().numpy(), outputs))
    assert not judge.verdict(judge.numbers(pairs), cell.limits)[0]
