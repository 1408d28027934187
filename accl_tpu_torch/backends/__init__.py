"""Backends of the port: the in-process CUDA gang engine (cuda.py)."""
