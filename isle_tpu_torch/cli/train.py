"""Training CLI of the port — the positional contract of the reference
ISLETrain and of isle_tpu.cli.train:

    python -m isle_tpu_torch.cli.train <tdf_file> <vocab_file> <output_dir>
        <vocab_size> <num_docs> <max_entries> <num_topics>
        <tf_idf 0/1> <sample 0/1> <sample_rate>
        <edge_topics 0/1> <max_edge_topics> [--seed N] [--device D]

--device is the torch device (default cuda; cpu runs the plain PyTorch
versions of the kernels). sample=1 samples documents at sample_rate.

Over several GPUs of one host, one process a card:

    torchrun --nproc_per_node=N -m isle_tpu_torch.cli.train <the same>

Each process reads WORLD_SIZE, RANK and LOCAL_RANK, joins the process
group (NCCL; gloo with --device cpu), binds to cuda:LOCAL_RANK and trains
with mesh_shape=(WORLD_SIZE,); rank 0 writes the run directory. Started
alone the CLI runs on one device.
"""

from __future__ import annotations

import sys

USAGE = (
    "Usage: python -m isle_tpu_torch.cli.train <tdf_file> <vocab_file> "
    "<output_dir> <vocab_size> <num_docs> <max_entries> <num_topics> "
    "<tf_idf 0/1> <sample 0/1> <sample_rate> <edge_topics 0/1> "
    "<max_edge_topics> [--seed N] [--device D]"
)


def _pop_flag(argv: list, name: str, default: str) -> str:
    if name not in argv:
        return default
    i = argv.index(name)
    if i + 1 >= len(argv):
        raise ValueError(f"{name} needs a value")
    value = argv[i + 1]
    del argv[i : i + 2]
    return value


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        seed = int(_pop_flag(argv, "--seed", "0"))
        device = _pop_flag(argv, "--device", "cuda")
    except ValueError as e:
        print(f"{e}\n{USAGE}", file=sys.stderr)
        return 1
    if len(argv) != 12:
        print(USAGE, file=sys.stderr)
        return 1

    from isle_tpu_torch.config import GpuConfig, TrainConfig
    from isle_tpu_torch.sharding import mesh_from_env
    from isle_tpu_torch.trainer import Trainer, check_supported

    (
        tdf_file,
        vocab_file,
        output_dir,
        vocab_size,
        num_docs,
        max_entries,
        num_topics,
        tf_idf,
        sample,
        sample_rate,
        edge_topics,
        max_edge_topics,
    ) = argv

    cfg = TrainConfig(
        num_topics=int(num_topics),
        vocab_size=int(vocab_size),
        num_docs=int(num_docs),
        tf_idf=bool(int(tf_idf)),
        sample_docs=bool(int(sample)),
        sample_rate=float(sample_rate),
        compute_edge_topics=bool(int(edge_topics)),
        max_edge_topics=int(max_edge_topics),
        seed=seed,
    )
    try:
        check_supported(cfg)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    device, mesh = mesh_from_env(device)
    gpu = GpuConfig(device=device,
                    mesh_shape=None if mesh is None else (mesh.world,))
    trainer = Trainer(cfg, output_dir=output_dir, vocab_file=vocab_file,
                      gpu=gpu, mesh=mesh)
    trainer.load_data_from_file(tdf_file)
    trainer.train()
    if not trainer.is_writer:  # rank 0 writes for all
        return 0
    trainer.output_cluster_summary()
    trainer.write_model_to_file()
    trainer.output_doc_topic()
    trainer.output_topic_diversity()
    if cfg.compute_edge_topics:
        trainer.train_edge_topics()
        trainer.write_edgemodel_to_file()
        trainer.print_top_two_topics()
    trainer.timer.report_total("ISLETrain")
    print(f"Model written to {trainer.run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
