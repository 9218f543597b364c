"""Training (PyTorch port of ``repro.training``): optimizers, the train
step, the synthetic data pipeline and checkpoints."""

from . import checkpoint, data, optimizer, train_step  # noqa: F401
