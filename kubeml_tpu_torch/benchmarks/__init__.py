"""Benchmarks of the port (``python -m kubeml_tpu_torch.benchmarks.<name>``)."""
