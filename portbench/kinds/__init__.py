"""The job loops of the traffic kinds; a traffic file names its kind.

A kind's module holds a class Cell(config, traffic, seed, device,
workdir) with setup(), job(i, mark) -> a record (units, phases: the
program's timer stages in seconds, written: the bytes the job wrote,
outputs), end_to_end(records, window_s), release(), judge(records) ->
(numbers, facts) and control(precision) -> numbers.
"""

import os


def bytes_under(path: str) -> int:
    """The bytes of the files under `path`."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)
