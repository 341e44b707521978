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
import threading
import time

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


def start_line(tool: str, device) -> str:
    """A CLI run's first log line: its torch.device and its text I/O
    backend (native.backend(), which builds the C library at first use)."""
    import torch

    from isle_tpu_torch import native

    name = (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else "")
    return f"{tool} on {device}{name}, text I/O {native.backend()}"


def status_bytes(field: str, path: str = "/proc/self/status"):
    """A `<field>: <n> kB` line of /proc/self/status in bytes (VmHWM, the
    process's own peak resident set, which exec resets; VmRSS, the
    present one), or None where the file or the field is missing."""
    try:
        with open(path) as f:
            for line in f:
                if line.startswith(f"{field}:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


class PeakRss:
    """This process's own peak RSS. getrusage's ru_maxrss will not do: a
    process started by fork (or vfork) and exec carries its starter's
    peak in it. Linux gives the own peak as VmHWM. Where
    /proc/self/status has VmRSS but no VmHWM (gVisor's, for one), a
    daemon thread reads VmRSS every `period` seconds from the start and
    keeps the largest: the peak, but for one shorter than the period.
    As a sink of a Timer's channel (`mark`) it notes the peak at each
    stage's end, and so the stage that reached it."""

    def __init__(self, period: float = 0.1):
        self.period = period
        self.sampled = 0
        self.stages: list = []  # (stage, the peak at its end)
        self._sampling = (status_bytes("VmHWM") is None
                          and status_bytes("VmRSS") is not None)
        if self._sampling:
            threading.Thread(target=self._sample, daemon=True).start()

    def _sample(self) -> None:
        while (rss := status_bytes("VmRSS")) is not None:
            self.sampled = max(self.sampled, rss)
            time.sleep(self.period)

    def bytes(self):
        """The peak so far, or None where it cannot be known."""
        hwm = status_bytes("VmHWM")
        if hwm is not None or not self._sampling:
            return hwm
        return max(self.sampled, status_bytes("VmRSS") or 0)

    def mark(self, message: str) -> None:
        if message.startswith("Time for "):
            stage = message[len("Time for "):message.index(": ")]
            self.stages.append((stage, self.bytes()))

    def __str__(self) -> str:
        peak = self.bytes()
        if peak is None:
            return "unknown"
        text = f"{peak / 2**30:.2f} GiB"
        if self._sampling:
            text += f" (VmRSS read every {self.period} s: no VmHWM here)"
        reached = next((stage for stage, b in self.stages
                        if b is not None and b >= peak), None)
        return text + (f", reached in {reached!r}" if reached else "")


def end_line(tool: str, device, peak: PeakRss) -> str:
    """A CLI run's last log line: its own peak RSS and, on the card, its
    peak device memory."""
    import torch

    line = f"{tool} done, peak RSS {peak}"
    if device.type == "cuda":
        mem = torch.cuda.max_memory_allocated(device) / 2**30
        line += f", peak device memory {mem:.2f} GiB"
    return line


def train_config(args, seed: int):
    """The TrainConfig of the contract's nine numeric arguments (<vocab_size>
    through <max_edge_topics>; <max_entries> is read by no stage)."""
    from isle_tpu_torch.config import TrainConfig

    (vocab_size, num_docs, _max_entries, num_topics, tf_idf, sample,
     sample_rate, edge_topics, max_edge_topics) = args
    return TrainConfig(
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


def main(argv=None) -> int:
    peak = PeakRss()
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

    from isle_tpu_torch.config import GpuConfig
    from isle_tpu_torch.sharding import mesh_from_env
    from isle_tpu_torch.trainer import Trainer, check_supported

    tdf_file, vocab_file, output_dir = argv[:3]
    cfg = train_config(argv[3:], seed)
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
    trainer.logger.add_sink("timer", peak.mark)
    trainer.logger.info(start_line("ISLETrain", trainer.device))
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
    trainer.logger.info(end_line("ISLETrain", trainer.device, peak))
    print(f"Model written to {trainer.run_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
