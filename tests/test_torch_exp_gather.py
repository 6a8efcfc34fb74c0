"""The port of `tools/exp_gather.py` against the reference on the CPU.

The reference defines its kernels inside `main()` (`try_form:48`,
`lut_kernel:152`, `pow_kernel:160`), so these tests recompute their bodies
with `jax.numpy` on the CPU from the same formulas and hold the port's
twins to them: the gather and the lut sum bit for bit, the pow sum within
8 ulps (torch's and XLA-CPU's `pow` differ by an ulp on a few inputs),
with the flips counted. Then, without the reference, what the kernels'
wrapper decides on the host: when the constant placement is filled, and
the staged layout the sums of 8 read (its reads give the table's bits for
every entry and lane), and the pow kernel's divides by constants, modelled
in exact arithmetic with the source's constants on every input the curve
gives them. The kernels themselves run only on a card:
`tests/test_torch_cuda.py`.
"""

import importlib.util
import json
import re
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu_torch.tools import exp_gather
from test_torch_divide import bits, fma, mul, rn32

REPEAT = 8
_CU = (Path(__file__).resolve().parents[1] / "kmeans_tpu_torch" / "tools" / "csrc"
       / "exp_gather.cu").read_text()


def _ref_table():
    # tools/exp_gather.py:47
    return (np.arange(256, dtype=np.float32) / 255.0) ** 2.4


def _ref_lut(idx):
    tbl = jnp.asarray(_ref_table())
    acc = jnp.zeros(idx.shape, jnp.float32)
    for j in range(REPEAT):
        acc = acc + tbl[(jnp.asarray(idx) + j) & 255]
    return np.array(acc)


def _ref_pow(idx):
    acc = jnp.zeros(idx.shape, jnp.float32)
    for j in range(REPEAT):
        c = ((jnp.asarray(idx) + j) & 255).astype(jnp.float32) / 255.0
        acc = acc + jnp.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)
    return np.array(acc)


def _grid(rows, seed):
    return exp_gather.grid_indices(np.random.default_rng(seed), rows)


def test_table_is_the_references():
    np.testing.assert_array_equal(exp_gather.gamma_table_np().view(np.uint32),
                                  _ref_table().view(np.uint32))
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(exp_gather.gather_indices(),
                                  rng.integers(0, 256, (128, 128)).astype(np.int32))


def test_grid_is_the_references_4k_grid():
    n = 3840 * 2160
    m = (n + 128 - 1) // 128
    assert exp_gather.GRID_ROWS == (m + 128 - 1) // 128 * 128 == 64_896


@pytest.mark.parametrize("placement", exp_gather.PLACEMENTS)
def test_gather_twin_returns_the_table_bits(placement):
    idx = exp_gather.gather_indices()
    want = np.asarray(jnp.asarray(_ref_table())[jnp.asarray(idx)])
    got = exp_gather.gather(exp_gather.gamma_table("cpu"), torch.from_numpy(idx), placement)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("rows,seed", [(128, 3), (256, 11)])
def test_lut_twin_matches_reference_bits(rows, seed):
    idx = _grid(rows, seed)
    got = exp_gather.lut_sum(exp_gather.gamma_table("cpu"), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), _ref_lut(idx).view(np.uint32))


@pytest.mark.parametrize("rows,seed", [(128, 3), (256, 11)])
def test_pow_twin_matches_reference_within_8_ulps(rows, seed):
    idx = _grid(rows, seed)
    got = exp_gather.pow_sum(torch.from_numpy(idx))
    ulps = exp_gather.ulps(got, torch.from_numpy(_ref_pow(idx)))
    assert int(ulps.max()) <= 8, f"{int((ulps > 0).sum())} sums differ, max {int(ulps.max())}"


def test_pow_table_twin_within_an_ulp_of_numpy():
    u = exp_gather.ulps(exp_gather.pow_table("cpu"), exp_gather.gamma_table("cpu"))
    assert int(u.max()) <= 1


def _const(name: str) -> np.float32:
    """A float constant of exp_gather.cu, read from its hex literal."""
    literal = re.search(rf"\b{name} = (-?0x[0-9a-f.]+p[-+]?\d+)f[;,]", _CU).group(1)
    return np.float32(float.fromhex(literal))


def _true_div(x, d) -> np.float32:
    return rn32(Fraction(float(x)) / Fraction(float(d)))


def _curve_inputs():
    """For each i < 256, (i, float(i) from the bits of 2^23 + i, less 2^23,
    as `srgb_c` forms it, and the twin's c = i / 255)."""
    twin = exp_gather.pow_probe_reference("cpu")
    for i in range(256):
        fi = np.array([0x4B000000 | i], np.uint32).view(np.float32)[0] - np.float32(2.0**23)
        yield i, fi, twin["c"][i].numpy()


def _curve_pair_divide(x, name: str) -> np.float32:
    """`div_by_pair(x, hi, rest)`: RN(x hi + RN(x rest))."""
    return fma(x, _const(name), mul(x, _const(f"{name}Rest")))


@pytest.mark.parametrize("d,hi", [(Fraction(255), "kInv255"), (Fraction(float(np.float32(1.055))),
                                                                 "kInv1055")])
def test_curve_reciprocals_are_two_floats_of_the_divisor(d, hi):
    """hi = RN(1 / d) and rest = RN(1 / d - hi), d as the float32 the
    reference divides by; and RN(1 / 12.92f) for the linear side."""
    assert _const(hi) == rn32(1 / d)
    assert _const(f"{hi}Rest") == rn32(1 / d - Fraction(float(_const(hi))))
    assert _const("kInv1292") == rn32(1 / Fraction(float(np.float32(12.92))))


@pytest.mark.parametrize("divide", ["i / 255", "(c + 0.055) / 1.055", "c / 12.92"])
def test_curve_divides_equal_true_division_on_every_input(divide):
    """Each divide of the pow kernel's curve, operation by operation in
    exact arithmetic (each rounded to float32, ties to even), equals the
    true divide and the twin's on every input the curve takes it on: i /
    255 on all 256 (from the exact float(i)), (c + 0.055) / 1.055 on the
    245 above the threshold, c / 12.92 (one product) on the 11 below."""
    twin = exp_gather.pow_probe_reference("cpu")
    taken = 0
    for i, fi, c in _curve_inputs():
        assert fi == i
        above = c > np.float32(0.04045)
        if divide == "i / 255":
            got, want, twin_value = _curve_pair_divide(fi, "kInv255"), _true_div(fi, 255), c
        elif divide == "(c + 0.055) / 1.055" and above:
            t = rn32(Fraction(float(c)) + Fraction(float(np.float32(0.055))))
            got, want = _curve_pair_divide(t, "kInv1055"), _true_div(t, np.float32(1.055))
            twin_value = twin["base"][i].numpy()
        elif divide == "c / 12.92" and not above:
            got, want = mul(c, _const("kInv1292")), _true_div(c, np.float32(12.92))
            twin_value = twin["linear"][i].numpy()
        else:
            continue
        taken += 1
        assert bits(got) == bits(want) == bits(twin_value), (divide, i, got, want)
    assert taken == {"i / 255": 256, "(c + 0.055) / 1.055": 245, "c / 12.92": 11}[divide]


def test_ulps_counts_units_in_the_last_place():
    a = torch.tensor([1.0, 2.0, 0.0])
    b = torch.nextafter(a, torch.full_like(a, 10.0))
    assert exp_gather.ulps(a, b).tolist() == [1, 1, 1]


def test_wrappers_reject_what_the_kernels_do_not_take():
    idx = torch.zeros((4, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        exp_gather.pow_sum(idx)
    with pytest.raises(ValueError, match="256"):
        exp_gather.gather(torch.zeros(128), idx.to(torch.int32))


def test_tool_on_cpu(capsys):
    assert exp_gather.main(["--cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["form"] for line in lines[:3]] == list(exp_gather.PLACEMENTS)
    assert all(line["correct"] for line in lines[:3])
    assert lines[3] == {"working_forms": list(exp_gather.PLACEMENTS)}
    assert lines[-1]["elements"] == exp_gather.GRID_ROWS * 128
    assert lines[-1]["pow_ms"] == "not measured"
    assert lines[-1]["fill_ms"] == lines[-1]["empty_ms"] == "not measured"
    probe = next(line["pow_curve_probe"] for line in lines if "pow_curve_probe" in line)
    assert {name: row["inputs"] for name, row in probe.items()} == {
        "curve_vs_powf": 256, "curve_vs_float64": 256, "divide_255": 256, "divide_1055": 245,
        "divide_1292": 11}
    # On the CPU the probe's rows are the twin's: the same bits throughout.
    for name in ("curve_vs_powf", "divide_255", "divide_1055", "divide_1292"):
        assert probe[name]["entries_differing"] == probe[name]["max_ulps"] == 0
    assert probe["curve_vs_float64"]["max_ulps"] <= 1


def test_staged_layout_matches_the_kernel_constants():
    assert re.search(r"constexpr int kRepeat = (\d+);", _CU).group(1) == str(REPEAT)
    assert re.search(r"constexpr int kSpan = 256 \+ kRepeat - 1;", _CU)
    assert exp_gather.STAGED_SPAN == 256 + REPEAT - 1 == 263
    assert int(re.search(r"constexpr int kLutCopies = (\d+);", _CU).group(1)) == \
        exp_gather.LUT_COPIES
    # The staged table is static shared memory (at most 48 KB a block), and
    # 6 such blocks of 256 threads fit an SM's 228 KB with 1 KB reserved each.
    staged = exp_gather.STAGED_SPAN * exp_gather.LUT_COPIES * 4
    assert staged <= 48 * 1024
    per_sm = int(re.search(r"constexpr int kSmemPerSM = (\d+);", _CU).group(1))
    reserved = int(re.search(r"constexpr int kSmemReserved = (\d+);", _CU).group(1))
    assert (per_sm, reserved) == (228 * 1024, 1024)
    assert min(8, per_sm // (staged + reserved)) == 6


def test_staged_reads_return_the_table_bits_for_every_entry_and_lane():
    table = exp_gather.gamma_table("cpu")
    words = exp_gather.staged_table(table)
    assert words.shape == (exp_gather.STAGED_SPAN * 32,)
    entry, j, lane = torch.meshgrid(torch.arange(256), torch.arange(REPEAT), torch.arange(32),
                                    indexing="ij")
    word = exp_gather.staged_word(entry, j, lane)
    assert int(word.max()) < words.numel()
    np.testing.assert_array_equal(words[word].numpy().view(np.uint32),
                                  table[(entry + j) & 255].numpy().view(np.uint32))
    # Every lane owns a bank: a warp's 32 reads are one pass, whatever the indices.
    assert torch.equal(word % 32, lane)


def test_staged_sum_equals_the_twin_bits():
    idx = torch.from_numpy(_grid(64, 7))
    # Indices past 255 and negative ones read `idx & 255`, as the kernel does.
    idx[0, :4] = torch.tensor([255, 256, -1, 2**31 - 1], dtype=torch.int32)
    lanes = torch.arange(idx.numel()).reshape(idx.shape) % 32
    table = exp_gather.gamma_table("cpu")
    got = exp_gather.lut_sum_staged(table, idx, lanes)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  exp_gather.lut_sum_reference(table, idx).numpy().view(np.uint32))


def _same(t):
    return t


def _write(t):
    t.mul_(1.0)
    return t


def _write_view(t):
    t[:8].zero_()
    return t


def _read(t):
    float(t.sum())
    return t


# (what happens to the table between two calls, what the second call
# passes, whether the second call must fill)
FILL_CASES = {
    "same tensor": (_same, 7, 1, False),
    "a read": (_read, 7, 1, False),
    "another stream": (_same, 8, 1, True),
    "another library": (_same, 7, 2, True),
    "another tensor, same bits": (torch.Tensor.clone, 7, 1, True),
    "an in-place write": (_write, 7, 1, True),
    "an in-place write through a view": (_write_view, 7, 1, True),
}


@pytest.mark.parametrize("case", list(FILL_CASES))
def test_constant_fill_follows_the_table(case):
    change, stream, lib, fills = FILL_CASES[case]
    table = exp_gather.gamma_table("cpu")
    resident = exp_gather.constant_key(table, 7, 1)
    assert exp_gather.needs_fill(None, resident)
    after = exp_gather.constant_key(change(table), stream, lib)
    assert exp_gather.needs_fill(resident, after) is fills


def test_constant_fill_without_a_version_counter_fills_every_call():
    with torch.inference_mode():
        frozen = exp_gather.gamma_table("cpu")
    assert exp_gather.constant_key(frozen, 7, 1) is None
    assert exp_gather.needs_fill(None, None)


def test_fill_refuses_a_table_off_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        exp_gather.fill_constant(exp_gather.gamma_table("cpu"))
    with pytest.raises(ValueError, match="256"):
        exp_gather.fill_constant(torch.zeros(128))


def test_chip_smoke_reads_the_sums_by_the_sources_constants():
    """`chip_smoke.py` divides the staged sums' element loop by the
    elements a thread takes an iteration (`kLutVec`) to count their table
    reads, and names the staged layout's copies (`kLutCopies`)."""
    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    for name, const in (("LUT_VEC", "kLutVec"), ("LUT_COPIES", "kLutCopies"),
                        ("POW_VEC", "kPowVec")):
        want = re.search(rf"constexpr int {const} = (\d+);", _CU).group(1)
        assert re.search(rf"\n{name} = (\d+)\n", smoke).group(1) == want
    assert int(re.search(r"constexpr int kLutVec = (\d+);", _CU).group(1)) % 4 == 0
    assert '"LDS*{8 * LUT_VEC}"' in smoke.replace("f\"LDS", "\"LDS")
    # The pow sum's element loop is found by its reciprocals, one an evaluation.
    assert 'f"pow_kernel<{POW_VEC}>": f"MUFU.RCP*{8 * POW_VEC}"' in smoke


# The pow sum's 4-element loop as `tools/sass.py::kernel_report` gives it,
# its opcodes as the card's compiler made them (32 evaluations a loop).
_POW_LOOP = {"FFMA": 672, "FADD": 476, "FMUL": 288, "IADD3": 94, "PRMT": 32, "MUFU.RCP": 32,
             "LDG.E.128.CONSTANT": 1, "STG.E.128": 1, "BRA": 1}
_POW_CASES = {
    "the kept loop": ({}, {}, None),
    "a table read": ({"LDS": 32}, {}, "LDS"),
    "a divide's slow path": ({"FCHK": 3, "CALL.REL.NOINC": 3}, {}, "FCHK"),
    "a conversion": ({"I2FP.F32.S32": 8}, {}, "I2F"),
    "a second global load": ({}, {"LDG.E.CONSTANT": 1}, "loop loads"),
    "a reciprocal short": ({}, {"MUFU.RCP": 31}, "31 MUFU.RCP"),
}


@pytest.mark.parametrize("case", list(_POW_CASES))
def test_chip_smoke_pow_kernel_check(case):
    """`chip_smoke.pow_kernel_check` passes the kept loop and names each
    breach: a shared read, a divide's slow path, a conversion, a global
    load besides the indices, fewer reciprocals than evaluations."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_pow", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kernel_extra, loop_extra, breach = _POW_CASES[case]
    loop = {**_POW_LOOP, **loop_extra}
    row = {"kernel": "pow_kernel<4>", "kernel_opcodes": {**loop, **kernel_extra},
           "spill_store_bytes": 0, "spill_load_bytes": 0, "loop_opcode": "MUFU.RCP*32",
           "loop": {"instructions": sum(loop.values()), "opcodes": loop}}
    if breach is None:
        got = smoke.pow_kernel_check(row)
        assert got["instructions_per_evaluation"] == sum(loop.values()) / 32
        assert got["global_loads_per_iteration"] == {"LDG.E.128.CONSTANT": 1}
    else:
        with pytest.raises(AssertionError, match=breach):
            smoke.pow_kernel_check(row)
