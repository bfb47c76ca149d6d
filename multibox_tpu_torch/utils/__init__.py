"""Host-side utilities: checkpoints and metrics."""
