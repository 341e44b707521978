"""The benchmark's own inputs: the frozen corpus generator and what it
makes from --seed."""
