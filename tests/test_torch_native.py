"""The port's own C I/O library (isle_tpu_torch/csrc/isle_io.cpp, built
with g++ at first use into build/isle_tpu_torch/) against the numpy plain
versions of isle_tpu_torch/native.py and against isle_tpu.native: every
entry point gives the same arrays and writes the same bytes. Skipped only
where g++ is missing."""

import concurrent.futures
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from isle_tpu import native as jnative
from isle_tpu_torch import _build, native

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the port's C I/O library cannot be built")


def test_the_library_is_the_ports_own_build():
    assert native.backend() == "native"
    lib = pathlib.Path(native._load()._name)
    assert lib.parent == pathlib.Path(_build.BUILD_DIR)
    assert lib.parent.relative_to(ROOT) == pathlib.Path("build",
                                                        "isle_tpu_torch")
    for path in (ROOT / "isle_tpu_torch").rglob("*"):
        if path.suffix in (".py", ".cpp", ".cu"):
            assert "native/" not in path.read_text(), path


def test_builders_starting_together_build_once(tmp_path, monkeypatch):
    """Four builders at once into an empty directory: one g++ run, one
    library, no temporary file left."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    real, calls = subprocess.run, []

    def counted(cmd, **kw):
        calls.append(cmd)
        return real(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", counted)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        paths = [f.result() for f in
                 [pool.submit(native.build) for _ in range(4)]]
    assert len(set(paths)) == 1 and len(calls) == 1
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".lock", ".so"]


TDF_TEXTS = {
    "plain": "1 2 3\n4 5 6\n7 8 9\n",
    "blank lines": "\n1 2 3\n\n\n4 5 6\n\n",
    "extra whitespace": "  1\t2   3 \n\t4 5\t\t6\r\n 7 8 9   \n",
    "no final newline": "1 2 3\n10 20 30",
    "big ids": "300000 102660 1000\n8200000 141043 7\n",
    "empty": "",
}


@pytest.mark.parametrize("name", TDF_TEXTS)
def test_parse_tdf(tmp_path, name):
    path = tmp_path / "c.tdf"
    path.write_text(TDF_TEXTS[name])
    got = native.parse_tdf(str(path))
    for other in (native.parse_tdf_plain(str(path)),
                  jnative.parse_tdf(str(path))):
        for a, b in zip(got, other):
            assert a.dtype == np.int64 and np.array_equal(a, b)


def _mixed_text(n: int, seed: int) -> str:
    """n triples of ids up to 10^7 apart by every separator the parser
    takes: spaces, tabs, runs of them, CRLF, blank lines (a triple may
    span lines)."""
    rng = np.random.default_rng(seed)
    seps = np.array([" ", "\t", "  ", " \t ", "\n", "\r\n", "\n\n"])
    vals = rng.integers(0, 10**7, 3 * n)
    return "".join(f"{v}{x}" for v, x in zip(vals, rng.choice(seps, 3 * n)))


@pytest.mark.parametrize("n", [7, 30_000])
def test_parse_tdf_across_the_workers_ranges(tmp_path, n):
    """The parse splits the file into one range a core, never inside a
    number: the arrays equal the serial parsers' for any separators."""
    path = tmp_path / "c.tdf"
    path.write_text(_mixed_text(n, n))
    got = native.parse_tdf(str(path))
    assert len(got[0]) == n
    for other in (native.parse_tdf_plain(str(path)),
                  jnative.parse_tdf(str(path))):
        for a, b in zip(got, other):
            assert a.dtype == np.int64 and np.array_equal(a, b)


def test_parse_tdf_rejects_a_cut_triple(tmp_path):
    path = tmp_path / "c.tdf"
    path.write_text("1 2 3\n4 5\n")
    for parse in (native.parse_tdf, native.parse_tdf_plain):
        with pytest.raises(ValueError):
            parse(str(path))


def _entries(seed, n, D=300, V=500):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, D, n), rng.integers(0, V, n),
            rng.integers(1, 9, n))  # unsorted, with duplicate pairs


@pytest.mark.parametrize("n", [0, 1, 5000])
def test_sort_dedup_entries(n):
    d, w, c = _entries(n, n)
    got = native.sort_dedup_entries(d, w, c)
    for other in (native.sort_dedup_entries_plain(d, w, c),
                  jnative.sort_dedup_entries(d, w, c)):
        for a, b in zip(got, other):
            assert np.array_equal(a, b)
    if n > 1:
        assert len(got[0]) < n  # duplicates were dropped


# (docs, words) id ranges whose sort keys take 1 to 6 radix passes of
# 11 bits: the sorted keys end in the docs' buffer or in the words'
KEY_WIDTHS = [(3, 5), (300, 500), (1 << 20, 8), (10**6, 10**5),
              (1 << 30, 1 << 30)]


@pytest.mark.parametrize("D,V", KEY_WIDTHS)
def test_sort_dedup_entries_in_place(D, V):
    """overwrite=True sorts in the given arrays (the keys in the docs'
    and the words' room): the same arrays as the plain sort and
    isle_tpu's at every key width, views of the arrays given."""
    d, w, c = _entries(D, 6000, D, V)
    want = native.sort_dedup_entries_plain(d, w, c)
    args = [a.copy() for a in (d, w, c)]
    path = []
    got = native.sort_dedup_entries(*args, overwrite=True, log=path.append)
    assert path == ["native radix sort (in place)"]
    for a, b, given in zip(got, want, args):
        assert a.dtype == np.int64 and np.array_equal(a, b)
        assert np.shares_memory(a, given)
    for a, b in zip(got, jnative.sort_dedup_entries(d, w, c)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("overwrite", [False, True])
@pytest.mark.parametrize("case", ["in order", "ids past int32"])
def test_sort_dedup_entries_paths(case, overwrite):
    """Entries already in strictly increasing (doc, word) order are kept
    as they are, after one check; ids past int32 take the lexsort. The
    arrays equal the plain sort's and isle_tpu's either way, and without
    overwrite the given arrays are left as they were."""
    d, w, c = _entries(11, 5000)
    if case == "in order":
        d, w, c = native.sort_dedup_entries_plain(d, w, c)
    else:
        d = d + 2**31
    args = [a.copy() for a in (d, w, c)]
    path = []
    got = native.sort_dedup_entries(*args, overwrite=overwrite,
                                    log=path.append)
    where = "in place" if overwrite else "on copies"
    assert path == [{
        "in order": f"none needed (already sorted and unique, {where})",
        "ids past int32":
            "numpy lexsort (ids past int32 or entries past 2^32 - 1)",
    }[case]]
    for want in (native.sort_dedup_entries_plain(d, w, c),
                 jnative.sort_dedup_entries(d, w, c)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, given, orig in zip(got, args, (d, w, c)):
        assert np.array_equal(given, orig) or overwrite
        assert np.shares_memory(a, given) == (
            overwrite and case == "in order")


def test_sort_raises_where_the_library_cannot_allocate(monkeypatch):
    """Where the C sort cannot allocate its indices it says so and the
    wrapper raises MemoryError: the lexsort would need more memory."""
    class Library:
        def isle_check_entries(self, *args):
            return 0  # in range, not in order

        def isle_sort_dedup_entries(self, *args):
            return -1

    monkeypatch.setattr(native, "_load", Library)
    with pytest.raises(MemoryError, match="indices for 100 entries"):
        native.sort_dedup_entries(*_entries(3, 100))


@pytest.mark.parametrize("n", [1, 4000])
def test_order_by(n):
    rng = np.random.default_rng(n)
    major = rng.integers(0, 50, n).astype(np.int32)
    minor = rng.integers(0, 7, n).astype(np.int32)  # ties: stability counts
    got = native.order_by(major, minor)
    assert got.dtype == np.int64
    assert np.array_equal(got, native.order_by_plain(major, minor))
    assert np.array_equal(got, jnative.order_by(major, minor))


def _same_bytes(tmp_path, write_ours, write_plain, write_ref):
    out = []
    for tag, write in (("ours", write_ours), ("plain", write_plain),
                       ("ref", write_ref)):
        path = tmp_path / tag
        write(str(path))
        out.append(path.read_bytes())
    assert out[0] == out[1] == out[2]
    return out[0]


def test_write_sparse_model(tmp_path):
    """Values at, just above and just below the 1e-8 cut, and near 1."""
    rng = np.random.default_rng(4)
    m = rng.random((40, 6)).astype(np.float32)
    m[m < 0.4] = 0.0
    cut = np.float32(1e-8)
    m[:6, 0] = [cut, np.nextafter(cut, np.float32(1)),
                np.nextafter(cut, np.float32(0)), np.float32(5e-9),
                np.float32(1.0), np.nextafter(np.float32(1), np.float32(0))]
    m[:, 5] = 0.0  # an empty topic
    text = _same_bytes(
        tmp_path,
        lambda p: native.write_sparse_model(p, m, base=1),
        lambda p: native.write_sparse_model_plain(p, m, base=1),
        lambda p: jnative.write_sparse_model(p, m, base=1))
    assert b"\t1.0000000000\n" in text and b"\t0.0000000100\n" in text
    _same_bytes(tmp_path,
                lambda p: native.write_sparse_model(p, m, base=0),
                lambda p: native.write_sparse_model_plain(p, m, base=0),
                lambda p: jnative.write_sparse_model(p, m, base=0))


@pytest.mark.parametrize("n", [0, 300])
@pytest.mark.parametrize("bases", [(1, 1, 1), (0, 5, 0)])
def test_write_triples(tmp_path, n, bases):
    rng = np.random.default_rng(n)
    a, b = rng.integers(0, 10**6, n), rng.integers(0, 100, n)
    c = rng.integers(0, 1000, n)
    v = (rng.random(n) * 10.0 ** rng.integers(-8, 3, n)).astype(np.float32)
    ba, bb, bc = bases
    _same_bytes(
        tmp_path,
        lambda p: native.write_float_triples(p, a, b, v, ba, bb),
        lambda p: native.write_float_triples_plain(p, a, b, v, ba, bb),
        lambda p: jnative.write_float_triples(p, a, b, v, ba, bb))
    _same_bytes(
        tmp_path,
        lambda p: native.write_int_triples(p, a, b, c, ba, bb, bc),
        lambda p: native.write_int_triples_plain(p, a, b, c, ba, bb, bc),
        lambda p: jnative.write_int_triples(p, a, b, c, ba, bb, bc))


def _hard_floats() -> np.ndarray:
    """float32 values where a fixed-point formatter can go wrong: dyadic
    ties at the 6th and 10th decimal (k / 2^j), subnormals, signed zeros
    and small negatives, values near the sparse writer's 1e-8 cut and
    near 2^40, and random bit patterns of every finite exponent."""
    rng = np.random.default_rng(0)
    k, j = np.meshgrid(np.arange(1, 400), np.arange(1, 40))
    ties = np.ldexp(k.ravel().astype(np.float64), -j.ravel())
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    rand = bits.view(np.float32)
    special = [0.0, -0.0, -1e-9, 1e-8, 1.0000001e-8, 9.999999e-9,
               2.5e-6, 1.5e-6, 0.99999994, 1099511627775.0,
               1099511627776.0, 3.4e38, -3.4e38, 1e-45, 1.1754944e-38]
    v = np.concatenate([ties, special]).astype(np.float32)
    return np.concatenate([v, rand[np.isfinite(rand)]])


def test_writers_format_every_float_as_printf_does(tmp_path):
    """The parallel writers' %.6f and %.10f give the bytes of the plain
    versions' Python formatting, which rounds the exact value half to
    even as glibc's printf does."""
    v = _hard_floats()
    n = len(v)
    a, b = np.arange(n) % 8_200_000, np.arange(n) % 141_043
    _same_bytes(
        tmp_path,
        lambda p: native.write_float_triples(p, a, b, v),
        lambda p: native.write_float_triples_plain(p, a, b, v),
        lambda p: jnative.write_float_triples(p, a, b, v))
    model = np.abs(v[: (n // 7) * 7]).reshape(-1, 7)
    _same_bytes(
        tmp_path,
        lambda p: native.write_sparse_model(p, model),
        lambda p: native.write_sparse_model_plain(p, model),
        lambda p: jnative.write_sparse_model(p, model))


@pytest.mark.parametrize("n", [2000, 3_000_000])
def test_a_written_tdf_reads_back(tmp_path, n):
    """The triple writer with bases (1, 1, 0) writes a 1-based TDF file
    that the parser reads back into the 0-based entries; at 3M lines
    (about 40 MB, ids up to PubMed's) each worker's range spans several
    of its 4 MB reads, so numbers cut by a read's end are joined."""
    d, w, c = native.sort_dedup_entries(*_entries(9, n, 8_200_000, 141_043))
    path = str(tmp_path / "c.tdf")
    native.write_int_triples(path, d, w, c, 1, 1, 0)
    for a, b in zip(native.parse_tdf(path), (d, w, c)):
        assert np.array_equal(a, b)
