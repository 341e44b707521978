"""Packaging of the port: isle_tpu_torch ships with its CUDA sources, adds
no console script, and neither it nor chip_smoke.py imports jax, the JAX
package isle_tpu or bench.py."""

import pathlib
import re
import subprocess
import sys
import tomllib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "isle_tpu_torch"


def test_every_package_dir_has_init():
    for d in [PKG, *PKG.rglob("*")]:
        if d.is_dir() and d.name not in ("__pycache__", "csrc"):
            assert (d / "__init__.py").exists(), f"missing __init__.py in {d}"


def test_sources_do_not_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|isle_tpu|bench)\b(?!_)",
                     re.M)
    sources = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in sources:
        m = pat.search(f.read_text())
        assert m is None, f"{f} imports {m.group(2)}"
    assert pat.search("from isle_tpu.corpus import Corpus")
    assert pat.search("  import bench")
    assert not pat.search("from isle_tpu_torch import sparse")


def test_pyproject_ships_the_port():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert "isle_tpu*" in meta["tool"]["setuptools"]["packages"]["find"][
        "include"]
    data = meta["tool"]["setuptools"]["package-data"]["isle_tpu_torch"]
    assert {"csrc/*.cu", "csrc/*.cuh"} <= set(data)
    assert any(d.startswith("torch") for d in
               meta["project"]["optional-dependencies"]["torch"])
    assert not any("torch" in s for s in meta["project"]["scripts"])
    assert list(PKG.glob("csrc/*.cu"))


@pytest.mark.parametrize("module", [
    "isle_tpu_torch", "isle_tpu_torch.mwu", "isle_tpu_torch.inferencer",
    "isle_tpu_torch.cli.infer", "isle_tpu_torch.cli.train",
    "isle_tpu_torch.trainer", "isle_tpu_torch.elkans",
    "isle_tpu_torch.streaming", "isle_tpu_torch.capi",
    "isle_tpu_torch.preprocessed", "isle_tpu_torch.sharding",
    "isle_tpu_torch.elkans_sharded", "isle_tpu_torch._build_capi",
])
def test_import_pulls_in_no_jax(module):
    """The card's host has no jax: importing a module of the port (and the
    package's lazy exports) loads no jax."""
    code = (
        "import importlib, sys\n"
        f"m = importlib.import_module({module!r})\n"
        "if m.__name__ == 'isle_tpu_torch':\n"
        "    m.Inferencer, m.InferConfig, m.Trainer, m.StreamedTrainer\n"
        "assert not [n for n in sys.modules if n.split('.')[0] == 'jax'], "
        "'jax imported'\n"
        "assert not [n for n in sys.modules\n"
        "            if n.split('.')[0] in ('isle_tpu', 'bench')], "
        "'isle_tpu or bench imported'\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr


def test_trains_and_infers_with_jax_isle_tpu_and_bench_blocked(tmp_path):
    """A meta-path finder refuses jax, isle_tpu and bench; the port still
    builds a corpus, trains it on the CPU with edge topics, writes the
    model and two reports, trains it again out of core, loads the model
    back and infers the corpus."""
    code = f"""
import sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "isle_tpu", "bench"):
            raise ImportError(f"blocked: {{name}}")


sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(ROOT)!r})
import os
import numpy as np
from isle_tpu_torch import (Corpus, GpuConfig, InferConfig, Inferencer,
                            TrainConfig, Trainer)
from isle_tpu_torch.synth import synth_corpus

d, w, c = synth_corpus(60, 120, 1500, seed=3)
corpus = Corpus.from_entries(d, w, c, vocab_size=60, num_docs=120,
                             sort_dedup=False)
cpu = GpuConfig(device="cpu")
tr = Trainer(TrainConfig(num_topics=3, seed=1, compute_edge_topics=True,
                         max_edge_topics=4),
             output_dir={str(tmp_path)!r}, quiet=True, gpu=cpu)
tr.load_corpus(corpus)
tr.train()
tr.train_edge_topics()
tr.write_model_to_file()
tr.output_avg_topic_coherence()
tr.compute_input_svd()
from isle_tpu_torch.streaming import StreamedTrainer
st = StreamedTrainer(tr.config, output_dir=os.path.join({str(tmp_path)!r}, "s"),
                     chunk_entries=400, gpu=cpu)
st.load_corpus(corpus)
st.train()
assert np.array_equal(st.cluster_of_doc, tr.cluster_of_doc)
assert np.allclose(st.model, tr.model, rtol=1e-5, atol=1e-7)
model_file = os.path.join(tr.run_dir, "M_hat_catch_sparse")
inf = Inferencer(InferConfig(num_topics=3, vocab_size=60),
                 model_file=model_file, output_dir={str(tmp_path)!r},
                 quiet=True, gpu=cpu)
res = inf.infer_corpus(Corpus.from_entries(d, w, c, vocab_size=60,
                                           num_docs=120,
                                           normalize_to_one=True))
assert res.weights.shape == (120, 3) and np.isfinite(res.weights).all()
assert res.num_converged > 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "isle_tpu",
                                                       "bench")]
assert not bad, bad
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def test_exports_cover_the_reference_package():
    """isle_tpu_torch exports what isle_tpu exports and the port has
    (TpuConfig's counterpart is GpuConfig), each name resolves, and the
    docstring names the trainers it holds. isle_tpu/__init__.py is read
    as text: importing it would not tell what it exports lazily."""
    import isle_tpu_torch

    src = (ROOT / "isle_tpu" / "__init__.py").read_text()
    block = src[src.index("__all__ = ["):]
    ref = set(re.findall(r'"(\w+)"', block[:block.index("]")]))
    assert {"StreamedTrainer", "EntryFeeder", "Trainer"} <= ref
    want = (ref - {"TpuConfig"}) | {"GpuConfig"}
    assert set(isle_tpu_torch.__all__) == want
    assert isle_tpu_torch.__all__ == sorted(isle_tpu_torch.__all__)
    for name in isle_tpu_torch.__all__:
        assert getattr(isle_tpu_torch, name).__name__ == name
    from isle_tpu_torch.corpus import EntryFeeder
    from isle_tpu_torch.streaming import StreamedTrainer
    assert isle_tpu_torch.StreamedTrainer is StreamedTrainer
    assert isle_tpu_torch.EntryFeeder is EntryFeeder
    with pytest.raises(AttributeError):
        isle_tpu_torch.TpuConfig
    doc = isle_tpu_torch.__doc__
    assert "StreamedTrainer" in doc and "EntryFeeder" in doc
    assert "single-device in-core training path" not in " ".join(doc.split())


def test_pyproject_ships_the_c_shim():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    data = meta["tool"]["setuptools"]["package-data"]["isle_tpu_torch"]
    assert "csrc/*.cpp" in data
    src = (PKG / "csrc" / "isle_capi_torch.cpp").read_text()
    assert 'PyImport_ImportModule("isle_tpu_torch.capi")' in src
    assert "isle_tpu.capi" not in src and "import jax" not in src
    for name in ("CreateTrainer", "DestroyTrainer", "feedData",
                 "finalizeData", "Train", "GetBasicModel",
                 "GetNumEdgeTopics", "GetEdgeModel"):
        assert re.search(rf"\b{name}\(", src), name
