"""The plain reference: numpy and plain PyTorch that import nothing of the
program, compute what each cell's program computes, and judge it."""
