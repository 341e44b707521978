"""Command-line entry points of the port (run as modules, e.g.
`python -m isle_tpu_torch.cli.train`)."""
