"""Host-side utilities: checkpoints, metrics, spans and the build lock."""
