"""On-device telemetry of the port (the per-window ring)."""
