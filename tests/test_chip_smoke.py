"""chip_smoke.py's helpers and comparison functions, on the CPU at the
harness's tiny widths. The script itself needs a GPU; what it decides and
compares is tested here."""

import gzip
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def _cpu():
    return jax.devices("cpu")[0]


def test_platform_check_refuses_cpu(capsys):
    """Without a GPU the script exits non-zero before printing anything."""
    with pytest.raises(SystemExit, match="needs a GPU") as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_fixture_is_deterministic_under_seed(tmp_path):
    truth = [cs.make_fixture(tmp_path / d, "c1", 300, s)
             for d, s in (("a", 4), ("b", 4), ("c", 5))]
    np.testing.assert_array_equal(truth[0], truth[1])
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert len(names) == 5

    def text(d, name):
        return gzip.decompress((tmp_path / d / name).read_bytes())

    for name in names:
        assert text("a", name) == text("b", name)
    assert any(text("a", n) != text("c", n) for n in names)


_TRACE_HEADER = "stage\tchrom\twall_s\tskipped\tattempts\tstatus\n"


@pytest.mark.parametrize(
    "rows, ok",
    [
        (["INFER[streambatched]\tc1\t2.5\tFalse\t1\tok",
          "GET_DMPS\tc1\t0.5\tFalse\t1\tok"], True),
        (["INFER[streambatched]\tc1\t2.5\tFalse\t1\tignored: RuntimeError",
          "GET_DMPS\tc1\t0.5\tFalse\t1\tok"], False),
        ([], False),
    ],
    ids=["all-ok", "ignored-row", "empty"],
)
def test_check_trace(rows, ok, tmp_path):
    (tmp_path / "trace.tsv").write_text(_TRACE_HEADER + "".join(r + "\n" for r in rows))
    if ok:
        assert cs.check_trace(tmp_path) == {"INFER[streambatched]": 2.5, "GET_DMPS": 0.5}
    else:
        with pytest.raises(cs.PhaseFailed):
            cs.check_trace(tmp_path)


def test_check_dmps_rejects_missing_and_malformed(tmp_path):
    d = tmp_path / "6_GET_DMPS" / "c1"
    d.mkdir(parents=True)
    header = ",".join(
        ["chrom", "position", "null_stats", "false_negative_weight"]
        + [f"Control_METEOR_{i + 1}" for i in range(6)]
        + [f"Case_METEOR_{i + 1}" for i in range(6)]
    )
    row = "c1,37," + ",".join(["0.1000"] * 14)
    for prefix in ("dmp", "weighted_dmp"):
        (d / f"{prefix}_0.05.csv").write_text(header + "\n" + row + "\n")
    assert cs.check_dmps(tmp_path, "c1", thresholds=(0.05,)) == {
        "dmp_0.05.csv": 1, "weighted_dmp_0.05.csv": 1,
    }
    (d / "dmp_0.05.csv").write_text(header + "\nc1,37,0.1\n")
    with pytest.raises(cs.PhaseFailed, match="malformed row"):
        cs.check_dmps(tmp_path, "c1", thresholds=(0.05,))
    with pytest.raises(cs.PhaseFailed, match="missing"):
        cs.check_dmps(tmp_path, "c1", thresholds=(0.01,))


def test_ops_checks_at_small_width():
    assert cs.check_tables(0, 256, _cpu())["ok"]
    assert cs.check_resampling(0, 10, 4, _cpu(), _cpu())["ok"]


@pytest.fixture(scope="module")
def two_group_runs():
    shape = (0, 192, 20, 32)  # the harness's tiny widths
    return cs.run_two_group_engine(*shape), cs.run_two_group_reference(*shape)


def test_two_group_comparison_passes_at_harness_widths(two_group_runs):
    engine, reference = two_group_runs
    assert engine[0].shape == (3,) and engine[1].shape == (3, 192)
    m = cs.compare_two_group(engine, reference)
    assert m["ok"], m
    assert not np.any(engine[3]), "degenerate filter steps"


def test_two_group_comparison_catches_a_wrong_engine(two_group_runs):
    engine, reference = two_group_runs
    logz, split, regime = engine[:3]
    assert not cs.compare_two_group((logz * 1.01, split, regime), reference)["ok"]
    assert not cs.compare_two_group((logz, 1.0 - split, regime), reference)["ok"]


def test_single_group_comparison():
    """Same program, same device: the CPU run agrees with itself; a shifted
    logZ falls outside the 3-standard-error band."""
    got = cs.run_single_group(0, 300, 30, _cpu())
    ref = cs.run_single_group(0, 300, 30, _cpu())
    assert got[0].shape == (3,) and got[2].shape == (3, 6)
    assert cs.compare_single_group(got, ref)["ok"]
    spread = np.std(ref[0], ddof=1)
    shifted = (got[0] + 4 * spread + 1e-3, got[1], got[2])
    assert not cs.compare_single_group(shifted, ref)["ok"]
