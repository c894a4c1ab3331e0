"""Command-line tools of the port (``python -m bio_ik_tpu_torch.tools.<name>``)."""
