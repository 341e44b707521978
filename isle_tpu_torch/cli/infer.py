"""Inference CLI of the port — the positional contract of the reference
ISLEInfer and of isle_tpu.cli.infer (ISLEInfer.cpp:10-36):

    python -m isle_tpu_torch.cli.infer <sparse_model_file> <infer_file>
        <output_dir> <num_topics> <vocab_size>
        <min_doc_id> <max_doc_id> <nnzs_in_infer_file>
        <nnzs_in_sparse_model_file> <iters|0> <Lf|0> [--device D]

--device is the torch device (default cuda; cpu runs on the host). Under
`torchrun --nproc_per_node=N -m isle_tpu_torch.cli.infer ...` the docs of
every block are split over the N processes, one a card, and rank 0 writes
the report (see isle_tpu_torch.cli.train).
"""

from __future__ import annotations

import sys

from isle_tpu_torch.cli.train import PeakRss, _pop_flag, end_line, \
    start_line

USAGE = (
    "Usage: python -m isle_tpu_torch.cli.infer <sparse_model_file> "
    "<infer_file> <output_dir> <num_topics> <vocab_size> "
    "<min_doc_id> <max_doc_id> <nnzs_in_infer_file> "
    "<nnzs_in_model_file> <iters|0 for default> <Lf|0 for default> "
    "[--device D]"
)


def main(argv=None) -> int:
    peak = PeakRss()
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        device = _pop_flag(argv, "--device", "cuda")
    except ValueError as e:
        print(f"{e}\n{USAGE}", file=sys.stderr)
        return 1
    if len(argv) != 11:
        print(USAGE, file=sys.stderr)
        return 1

    from isle_tpu_torch.config import GpuConfig, InferConfig
    from isle_tpu_torch.inferencer import Inferencer
    from isle_tpu_torch.sharding import mesh_from_env

    (
        model_file,
        infer_file,
        output_dir,
        num_topics,
        vocab_size,
        doc_begin,
        doc_end,
        max_entries,
        _model_entries,
        iters,
        Lf,
    ) = argv
    cfg = InferConfig(
        num_topics=int(num_topics),
        vocab_size=int(vocab_size),
        iters=int(iters),
        Lf=float(Lf),
    )
    device, mesh = mesh_from_env(device)
    gpu = GpuConfig(device=device,
                    mesh_shape=None if mesh is None else (mesh.world,))
    inf = Inferencer(cfg, model_file=model_file, output_dir=output_dir,
                     gpu=gpu, mesh=mesh)
    inf.logger.add_sink("timer", peak.mark)
    inf.logger.info(start_line("ISLEInfer", inf.device))
    inf.infer_file(
        infer_file,
        doc_begin=int(doc_begin),
        doc_end=int(doc_end),
        max_entries=int(max_entries) or None,
    )
    inf.timer.report_total("ISLEInfer")
    inf.logger.info(end_line("ISLEInfer", inf.device, peak))
    return 0


if __name__ == "__main__":
    sys.exit(main())
