"""The plain reference of the configurations the benchmark runs: plain
PyTorch, importing nothing of the measured program."""
