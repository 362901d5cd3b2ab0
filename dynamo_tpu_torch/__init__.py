"""dynamo_tpu_torch: the PyTorch/CUDA port of dynamo_tpu's serving path."""

__version__ = "0.4.0"
