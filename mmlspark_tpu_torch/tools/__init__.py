"""Operational drills of the port (``python -m mmlspark_tpu_torch.tools.*``)."""
