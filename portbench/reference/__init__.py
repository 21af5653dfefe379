"""The plain references a pass is held to. Nothing here imports the
program (``shadow1_tpu_torch``), JAX or the JAX package."""
