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
    "isle_tpu_torch.streaming_sharded", "isle_tpu_torch.hybrid",
    "isle_tpu_torch.matops", "isle_tpu_torch.graft_entry",
    "isle_tpu_torch.micro_kernels", "isle_tpu_torch.benchmarks.micro_pallas",
    "isle_tpu_torch.benchmarks.micro_pallas_gather",
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
    model and two reports, trains it again out of core (alone and over a
    mesh of one rank), loads the model back, infers the corpus and runs
    graft_entry's step."""
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
from isle_tpu_torch.sharding import Mesh
ms = StreamedTrainer(tr.config,
                     output_dir=os.path.join({str(tmp_path)!r}, "ms"),
                     chunk_entries=400, gpu=cpu, mesh=Mesh("cpu"))
ms.load_corpus(corpus)
ms.train()
assert np.array_equal(ms.model, st.model)
model_file = os.path.join(tr.run_dir, "M_hat_catch_sparse")
inf = Inferencer(InferConfig(num_topics=3, vocab_size=60),
                 model_file=model_file, output_dir={str(tmp_path)!r},
                 quiet=True, gpu=cpu)
res = inf.infer_corpus(Corpus.from_entries(d, w, c, vocab_size=60,
                                           num_docs=120,
                                           normalize_to_one=True))
assert res.weights.shape == (120, 3) and np.isfinite(res.weights).all()
assert res.num_converged > 0
from isle_tpu_torch.graft_entry import entry
fn, args = entry("cpu")
assert fn(*args)[0].shape == (512, 128)
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


def _public_callables():
    """(qualified name, callable) of every public function and class of
    every module of the port (a class stands for its constructor)."""
    import importlib
    import inspect

    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        name = ".".join(parts)
        mod = importlib.import_module(name)
        for attr, obj in vars(mod).items():
            if attr.startswith("_") or getattr(obj, "__module__", "") != name:
                continue
            if inspect.isfunction(obj) or inspect.isclass(obj):
                yield f"{name}.{attr}", obj
            if inspect.isclass(obj):
                for meth, fn in vars(obj).items():
                    if inspect.isfunction(fn) and not meth.startswith("_"):
                        yield f"{name}.{attr}.{meth}", fn


def test_no_public_device_defaults_to_the_cpu():
    """Every entry point runs on the card unless its caller names the CPU:
    no public function, method or constructor of the port has a `device`
    parameter whose default is "cpu"."""
    import inspect

    seen, bad = [], []
    for qual, obj in _public_callables():
        try:
            params = inspect.signature(obj).parameters
        except (TypeError, ValueError):
            continue
        p = params.get("device")
        if p is None or p.default is inspect.Parameter.empty:
            continue
        seen.append(qual)
        if str(p.default) == "cpu":
            bad.append(qual)
    assert not bad, f"device defaults to the CPU in {bad}"
    # the walk reaches the entry points that have such a default
    assert "isle_tpu_torch.mwu.infer_all" in seen
    assert "isle_tpu_torch.graft_entry.entry" in seen
    assert "isle_tpu_torch.graft_entry.dryrun_multichip" in seen
    assert "isle_tpu_torch.config.GpuConfig" in seen


def test_import_pins_float32_matmul_precision():
    """Importing the port turns TF32 off and forbids cuBLAS's reduced
    precision reductions of bf16 products (the hybrid head product must
    sum in float32), whatever the flags were before."""
    code = (
        "import torch\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "torch.backends.cuda.matmul."
        "allow_bf16_reduced_precision_reduction = True\n"
        "import isle_tpu_torch\n"
        "m = torch.backends.cuda.matmul\n"
        "assert not m.allow_tf32 and not torch.backends.cudnn.allow_tf32\n"
        "assert not m.allow_bf16_reduced_precision_reduction\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr


# TpuConfig's fields that GpuConfig does not carry with the same name and
# default, each with the reason. A field added to TpuConfig that is in
# neither GpuConfig nor this table fails test_config_surface.
NOT_IN_GPU_CONFIG = {
    "lane": "TPU padding: the vector unit's 128 lanes",
    "sublane": "TPU padding: the vector unit's 8 sublanes",
    "spmm_chunk": "the chunk of isle_tpu's scanned XLA SpMM; the kernels "
                  "here take seg_chunk",
    "mesh_axis_names": "a jax.sharding.Mesh's axis names; the port's mesh "
                       "is one process group along the docs",
    "pallas_segsum": "the port always runs its kernels on the card",
    "pallas_chunk": "its counterpart is seg_chunk",
    "precise_matmul": "read nowhere in isle_tpu; the port turns TF32 off "
                      "on import (isle_tpu_torch/__init__.py)",
}
# fields of both whose defaults differ, with the reason
OTHER_DEFAULT = {
    "mesh_shape": "None means one device, as isle_tpu's ()",
    "hbm_bytes": "0 takes the card's memory; isle_tpu's 14 GiB describe "
                 "a v5e",
}
# GpuConfig's own fields
GPU_ONLY = {"device", "seg_chunk"}


def test_config_surface():
    """Every field of isle_tpu's TpuConfig has a GpuConfig field of the
    same name and default, or stands in one of the tables above with its
    reason; GpuConfig adds only its own fields."""
    import dataclasses

    from isle_tpu.config import TpuConfig
    from isle_tpu_torch.config import GpuConfig

    ref = {f.name: f.default for f in dataclasses.fields(TpuConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(GpuConfig)}
    for name, default in ref.items():
        if name in NOT_IN_GPU_CONFIG:
            assert name not in ours, name
        elif name in OTHER_DEFAULT:
            assert name in ours and ours[name] != default, name
        else:
            assert name in ours, f"TpuConfig.{name} has no counterpart"
            assert ours[name] == default, name
    assert set(NOT_IN_GPU_CONFIG) | set(OTHER_DEFAULT) <= set(ref)
    assert set(ours) - set(ref) == GPU_ONLY
    assert "break_head_cap" in ours and ours["break_head_cap"] is False
    assert ours["seg_chunk"] == ref["pallas_chunk"]
    # precise_matmul is declared in isle_tpu's config and read nowhere
    readers = [p.name for p in (ROOT / "isle_tpu").rglob("*.py")
               if "precise_matmul" in p.read_text()]
    assert readers == ["config.py"], readers
