"""Prototxt and blob file reading."""
