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


def test_a_written_tdf_reads_back(tmp_path):
    """The triple writer with bases (1, 1, 0) writes a 1-based TDF file
    that the parser reads back into the 0-based entries."""
    d, w, c = native.sort_dedup_entries(*_entries(9, 2000))
    path = str(tmp_path / "c.tdf")
    native.write_int_triples(path, d, w, c, 1, 1, 0)
    for a, b in zip(native.parse_tdf(path), (d, w, c)):
        assert np.array_equal(a, b)
