"""Host-side utilities: checkpoints, metrics and the build lock."""
