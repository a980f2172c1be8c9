"""Command-line tools of the port (``python -m gomatching_tpu_torch.tools.<name>``)."""
