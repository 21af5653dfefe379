from shadow1_tpu_torch.cpu_engine.engine import CpuEngine  # noqa: F401
