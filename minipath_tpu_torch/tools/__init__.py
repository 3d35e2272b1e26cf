"""Command-line tools of the port, run as ``python -m minipath_tpu_torch.tools.<name>``."""
