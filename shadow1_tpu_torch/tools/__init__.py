"""Operator tools of the port (``python -m shadow1_tpu_torch.tools.NAME``),
each the counterpart of the reference's tool of the same name."""
