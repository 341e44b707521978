"""The port's two layouts held against each other: the counterpart of
tests/test_variants.py::test_trainer_cross_layout_agreement.

One planted corpus (test_end_to_end.planted_corpus, rng 33, V 60, D 300,
k 4) is trained on the hybrid dense-head layout (GpuConfig's 4 GiB
budget, every word in the head) and on COO (dense_head_bytes=0). The
layouts compute the same operator up to float summation order, so the
runs must agree to the reference's bounds: eigenvalues within rtol 1e-4,
clusters equal on more than 99% of docs, models within rtol 1e-4 / atol
1e-6. The second case holds the port's hybrid run against isle_tpu's COO
run on the same corpus (the port replays isle_tpu's key schedule)."""

import numpy as np
import pytest

from isle_tpu.config import HyperParams, TpuConfig, TrainConfig
from isle_tpu.trainer import Trainer as JaxTrainer
from isle_tpu_torch.config import GpuConfig
from isle_tpu_torch.trainer import Trainer
from test_end_to_end import planted_corpus
from torch_parity import JaxDraws

V, D, K = 60, 300, 4
HEAD = 4 << 30


def _tdf(tmp_path):
    text, _ = planted_corpus(np.random.default_rng(33), V, D, K)
    path = tmp_path / "c.tdf"
    path.write_text(text)
    return str(path)


def _config(head_bytes):
    return TrainConfig(num_topics=K, seed=0,
                       hyper=HyperParams(block_ks_block_size=8),
                       tpu=TpuConfig(dense_head_bytes=head_bytes))


def _port(tdf, out, head_bytes):
    cfg = _config(head_bytes)
    tr = Trainer(cfg, output_dir=str(out), quiet=True,
                 gpu=GpuConfig(device="cpu", dense_head_bytes=head_bytes),
                 draws=JaxDraws(cfg.seed))
    tr.load_data_from_file(tdf)
    tr.train()
    return tr


def _jax(tdf, out, head_bytes):
    tr = JaxTrainer(_config(head_bytes), output_dir=str(out), quiet=True)
    tr.load_data_from_file(tdf)
    tr.train()
    return tr


@pytest.mark.parametrize("coo", [_port, _jax], ids=["port-coo", "jax-coo"])
def test_hybrid_agrees_with_coo(tmp_path, coo):
    tdf = _tdf(tmp_path)
    hy = _port(tdf, tmp_path / "hybrid", HEAD)
    ref = coo(tdf, tmp_path / "coo", 0)
    assert any(label == "creating thresholded matrix (fused hybrid)"
               for label, *_ in hy.timer.phases)
    np.testing.assert_allclose(np.asarray(hy.evalues),
                               np.asarray(ref.evalues), rtol=1e-4)
    agree = float(np.mean(hy.cluster_of_doc == ref.cluster_of_doc))
    assert agree > 0.99, f"cluster agreement {agree}"
    np.testing.assert_allclose(hy.model, ref.model, rtol=1e-4, atol=1e-6)
