"""The parser's tiers: lightgbm_tpu_torch.io.parser against
lightgbm_tpu.io.parser on adversarial tokens, bitwise.

Both packages parse delimited text through the same tiers in the same
order: the native C++ parser (built with g++ at first use), the pandas C
engine, the exact per-token loop.  The tiers disagree with each other on
a token such as ``1.5abc`` (``strtod`` reads 1.5, the others 0: ROADMAP
C4, the JAX package's own divergence), so the port must take the same
tier as the JAX package on the same host; each tier is also held against
its JAX twin alone.  Tolerance: none (float64 bit patterns).
"""
import shutil
import sys

import numpy as np
import pytest

from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu.utils.log import LightGBMError as JError

from lightgbm_tpu_torch.io import parser as tparser
from lightgbm_tpu_torch.native import lib as native_lib
from lightgbm_tpu_torch.utils import log

LONG = "1." + "1234567890" * 7   # 72 characters: strtod sees 63 of them
CASES = {
    "garbage-suffix": ["1,1.5abc,NaN,1e-11,inf,  2.5 ",
                       "0,x,na,3,-inf,4"],
    "na-casings": [",".join(["1"] + tparser._NA_SPELLINGS),
                   ",".join(["0"] + ["2.5"] * len(tparser._NA_SPELLINGS))],
    "tiny-and-inf": ["1,1e-11,-1e-10,1e-9,+inf,-Infinity",
                     "0,1e-300,5e-324,1.7976931348623157e308,inf,INF"],
    "whitespace": ["1, 2.5 ,\t3,  -4.0  ", "0,1 , 2,3 "],
    "long-token": ["1,%s,2" % LONG, "0,3,%s" % LONG],
    "crlf": ["1,2.5,3\r", "0,-1,4.25\r"],
    "empty-tokens": ["1,,3", "0,2,"],
    "hex-and-underscore": ["1,0x1A,1_000", "0,0x10,2_5"],
    "plain": ["%d,%.6f,%.17g" % (i % 2, i * 0.37, 1.0 / (i + 1))
              for i in range(50)],
}


def bitwise_equal(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


def parse_with_tier(lines, delim=","):
    """The port's parse and the one tier that took it."""
    before = dict(tparser.tier_calls)
    out = tparser._parse_delimited_fast(lines, delim)
    used = [t for t, n in tparser.tier_calls.items() if n != before[t]]
    assert len(used) == 1, used
    return out, used[0]


@pytest.fixture
def tiers_off(monkeypatch):
    """Switch tiers off in both packages: ``off("native")`` leaves pandas
    and exact, ``off("native", "pandas")`` the exact tier alone."""
    def off(*names):
        if "native" in names:
            monkeypatch.setattr(jparser, "_try_native", lambda: None)
            monkeypatch.setattr(native_lib, "parse_delimited",
                                lambda lines, delim: None)
        if "pandas" in names:
            monkeypatch.setattr(jparser, "_parse_delimited_pandas",
                                lambda lines, delim: None)
            monkeypatch.setattr(tparser, "_parse_delimited_pandas",
                                lambda lines, delim: None)
    return off


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiers_match_jax_bitwise(case):
    """The default tier order on this host, token by token."""
    lines = CASES[case]
    want = jparser._parse_delimited_fast(lines, ",")
    got = tparser._parse_delimited_fast(lines, ",")
    assert bitwise_equal(got, want), (got, want)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tiers", ["pandas+exact", "exact"])
def test_each_tier_matches_jax(case, tiers, tiers_off):
    lines = CASES[case]
    tiers_off(*(("native",) if tiers == "pandas+exact"
                else ("native", "pandas")))
    want = jparser._parse_delimited_fast(lines, ",")
    got, tier = parse_with_tier(lines)
    assert bitwise_equal(got, want), (got, want)
    assert tier != "native"
    if tiers == "exact":
        assert tier == "exact"


@pytest.mark.parametrize("delim,name", [(",", "CSV"), ("\t", "TSV")])
def test_ragged_rows_are_the_jax_fatal(delim, name):
    lines = ["1%s2%s3" % (delim, delim), "0%s1" % delim]
    with pytest.raises(JError) as want:
        jparser._parse_delimited_fast(lines, delim)
    before = dict(tparser.tier_calls)
    with pytest.raises(log.Fatal) as got:
        tparser._parse_delimited_fast(lines, delim)
    assert str(got.value) == str(want.value) == \
        "input format error, should be %s" % name
    assert tparser.tier_calls == before


def test_native_tier_built_and_used():
    """With g++ present the native library builds into the ignored
    ``_build/`` and parses: the C4 token reads as strtod reads it."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native tier cannot build here")
    assert native_lib.available(), native_lib.build_error
    assert "/_build/" in native_lib.library_path()
    out, tier = parse_with_tier(["1,1.5abc,na", "0,2,3"])
    assert tier == "native"
    assert out[0, 1] == 1.5 and out[0, 2] == 0.0


def test_c4_tiers_disagree_on_garbage_suffix(tiers_off):
    """ROADMAP C4's reproduction: the JAX package's native tier reads
    ``1.5abc`` as 1.5, its exact tier as 0; the port's tiers agree with
    them tier by tier."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native tier cannot build here")
    lines = ["1,1.5abc,NaN,1e-11,inf,  2.5 ", "0,x,na,3,-inf,4"]
    native = tparser._parse_delimited_fast(lines, ",")
    assert jparser._try_native() is not None
    assert bitwise_equal(native, jparser._parse_delimited_fast(lines, ","))
    tiers_off("native", "pandas")
    exact = tparser._parse_delimited_fast(lines, ",")
    assert bitwise_equal(exact, jparser._parse_delimited_fast(lines, ","))
    assert native[0, 1] == 1.5 and exact[0, 1] == 0.0
    exact[0, 1] = native[0, 1]
    assert bitwise_equal(native, exact)


@pytest.mark.parametrize("label_idx", [0, 2, -1])
def test_csv_parser_matches_jax(label_idx):
    """Label removal and the zero threshold over the default tiers."""
    rng = np.random.RandomState(label_idx + 3)
    rows = rng.randn(40, 5)
    rows[::7, 1] = 3e-11
    lines = [",".join("%.12g" % v for v in r) for r in rows]
    lines[5] = lines[5].replace(lines[5].split(",")[3], "nan", 1)
    want = jparser.CSVParser(label_idx).parse(lines)
    got = tparser.CSVParser(label_idx).parse(lines)
    assert bitwise_equal(got.features, want.features)
    assert bitwise_equal(got.labels, want.labels)


def test_pandas_absent_quietly(monkeypatch, tiers_off):
    """Without pandas (the card machine has none) the parse drops to the
    exact tier after one warning."""
    tiers_off("native")
    monkeypatch.setitem(sys.modules, "pandas", None)
    monkeypatch.setattr(tparser, "_warned_no_pandas", False)
    lines = CASES["garbage-suffix"]
    got, tier = parse_with_tier(lines)
    assert tier == "exact"
    assert tparser._warned_no_pandas
    tparser._parse_delimited_fast(lines, ",")
    monkeypatch.setattr(jparser, "_WARNED_NO_PANDAS", False)
    want = jparser._parse_delimited_fast(lines, ",")
    assert bitwise_equal(got, want)


def test_tsv_and_libsvm_match_jax(tmp_path):
    """Format sniffing and the other parsers over the same files."""
    rng = np.random.RandomState(2)
    x = rng.randn(30, 4)
    tsv = tmp_path / "t.tsv"
    tsv.write_text("".join("%d\t%s\n" % (i % 2, "\t".join(
        "%.6f" % v for v in x[i])) for i in range(30)))
    svm = tmp_path / "t.svm"
    svm.write_text("".join("%d %s\n" % (i % 2, " ".join(
        "%d:%.6f" % (j, x[i, j]) for j in range(4) if x[i, j] > -0.5))
        for i in range(30)))
    for path in (str(tsv), str(svm)):
        jp = jparser.create_parser(path, False, 0, 0)
        tp = tparser.create_parser(path, False, 0, 0)
        assert type(tp).__name__ == type(jp).__name__
        lines = tparser.read_lines(path)
        assert lines == jparser.read_lines(path)
        got, want = tp.parse(lines), jp.parse(lines)
        assert bitwise_equal(got.features, want.features)
        assert bitwise_equal(got.labels, want.labels)
