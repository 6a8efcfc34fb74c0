"""The port's randomized soak (`kmeans_tpu_torch/tools/soak.py`) on the
CPU: a short run of its sections, and a planted fault it must catch. No
reference call. The heavy-bucket section is left to the card's run
(`chip_smoke.py`'s `soak_slice`): one trial of it trains k = 65 on the
accumulator's twin for ~17 s on one core; `tests/test_torch_many.py`
covers that route here."""

from __future__ import annotations

from kmeans_tpu_torch.ops import kernels
from kmeans_tpu_torch.tools import soak


def test_soak_sections_pass_on_the_cpu():
    names = [name for name, _, _ in soak.SECTIONS if name != "heavy-bucket"]
    out = soak.run(trials=2, seed=7, budget=4.0, device="cpu", only=set(names))
    assert sorted(out["trials"]) == sorted(names)
    assert all(out["trials"][name] >= 1 for name in names)
    assert out["failures"] == {name: 0 for name in names}, out["messages"]


def test_soak_catches_a_flipped_index(monkeypatch, capsys):
    """A twin that moves one pixel to another palette entry fails the
    kernel section and the soak's exit code."""
    twin = kernels.quantize_rgba_reference

    def flipped(rgb_u8, centroids_lab, *args, **kwargs):
        out = twin(rgb_u8, centroids_lab, *args, **kwargs).clone()
        out[0, 0, :3] = 255 - out[0, 0, :3]
        return out

    monkeypatch.setattr(kernels, "quantize_rgba_reference", flipped)
    assert soak.main(["3", "--cpu", "--seed", "2", "--sections", "kernels"]) == 1
    printed = capsys.readouterr().out
    assert "[FAIL] kernels:" in printed and '"kernels": ' in printed
