"""The plain PyTorch reference the benchmark's check compares with:
frozen copies of the port's plain versions, importing nothing of the
program."""
