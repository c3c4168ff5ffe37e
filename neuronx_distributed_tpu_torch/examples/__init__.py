"""Launchers of the PyTorch port (``python -m
neuronx_distributed_tpu_torch.examples.<name>``)."""
