"""Experiment configuration: YAML → CompiledExperiment (numpy, host-side)."""
