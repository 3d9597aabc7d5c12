"""The PyTorch and CUDA port's benchmark: harness, configurations, traffic,
metric readers and plain references (see `run.py`)."""
