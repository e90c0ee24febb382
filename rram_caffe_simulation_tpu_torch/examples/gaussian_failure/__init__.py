"""The gaussian-failure sweep drivers."""
