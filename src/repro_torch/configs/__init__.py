"""Architectures the port serves (one module each, as ``repro.configs``)."""
