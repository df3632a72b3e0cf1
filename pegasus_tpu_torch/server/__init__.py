"""The port's server entry point: python -m pegasus_tpu_torch.server."""
