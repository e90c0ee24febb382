"""Layer registry and fillers."""
